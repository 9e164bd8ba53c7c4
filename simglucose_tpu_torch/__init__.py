"""simglucose_tpu_torch: the PyTorch + CUDA port of simglucose_tpu.

The same UVA/Padova 2008 T1D cohort simulator as the JAX package beside it,
written as plain PyTorch functions over tensors, with the closed-loop
rollout kernel and the PPO learner's kernels hand-written in CUDA C++ for
Hopper (``csrc/``).  The JAX package stays the reference; this package
never imports ``jax``.

Main entries: :func:`simglucose_tpu_torch.sim.engine.simulate` (and its
pandas-free core :func:`~simglucose_tpu_torch.sim.engine.simulate_cohort`),
and fused PPO training,
:func:`simglucose_tpu_torch.rl.fused.make_fused_train_loop`.
"""
__version__ = "0.1.0"
