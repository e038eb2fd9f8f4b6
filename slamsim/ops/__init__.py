"""Hand-written kernels for the hot paths."""

from slamsim.ops.ekf_pallas import ekf_fused_rollout

__all__ = ["ekf_fused_rollout"]
