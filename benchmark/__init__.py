"""The benchmark of simglucose_tpu_torch (see README.md)."""
