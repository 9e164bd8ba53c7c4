"""The plain reference the benchmark holds the program's outputs against.

Plain PyTorch written from the published models, independent of the
program: it imports nothing of ``simglucose_tpu_torch`` (nor JAX), reads
the patient, sensor, pump and therapy tables from their raw JSON files,
and works out everything the program derives from them (packed
parameters, basal rates, learner rows) again.  Every function takes a
``dtype``: float32 is the configurations' precision, and bfloat16 is the
control that a comparison has to fail.
"""
