"""The JAX package's ``examples/*.py`` on the port, one module each, run
with ``python -m simglucose_tpu_torch.examples.<name>``.

Each module has a ``main(...)`` whose defaults are the JAX script's sizes
and whose ``device`` defaults to ``"cuda"``; importing a module runs
nothing.  Several need packages the card's machine lacks: the results
frame of ``simulate()`` needs pandas, ``offline_analysis`` also
matplotlib, ``run_gym`` gymnasium.
"""
