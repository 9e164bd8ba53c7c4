"""compat layer of the PyTorch port (see the JAX package's simglucose_tpu.compat)."""
