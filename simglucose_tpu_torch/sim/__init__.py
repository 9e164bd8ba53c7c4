"""High-level simulation API of the port: cohort sims and the SimObj shim."""
from simglucose_tpu_torch.sim.engine import SimObj, batch_sim, sim, simulate

__all__ = ["simulate", "SimObj", "sim", "batch_sim"]
