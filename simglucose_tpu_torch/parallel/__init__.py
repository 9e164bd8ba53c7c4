"""Multi-device runs of the port on ``torch.distributed``: one rank per
device, every rank calling the same entry point with the same global
arguments (SPMD), the patient batch split over the ranks (the ``dp`` axis).

Counterpart of ``simglucose_tpu/parallel/``: :mod:`.multihost` brings the
process group up and writes per-rank results, :mod:`.sharding` holds the
mesh and the tree helpers, :mod:`.dryrun` the multi-rank dry run.
"""
