"""Reinforcement learning: the Gaussian MLP policy and fused PPO training."""
