"""Observation models for the EKF and PF demos, batched + keyed.

Capability parity:
  * :func:`position_observation` - the EKF's GPS-like position observation
    (extended_kalman_filter.py:132-146, ``__observation``): the observation
    is the true (x, y) with noise drawn in the *robot* frame and rotated to
    world via robot2world.  (In the reference, ``C @ x_l`` with
    ``x_l = [0, 0, 90deg]`` is identically zero, so the robot-frame value is
    just the noise vector ``w``.)
  * :func:`landmark_observation` - the PF's landmark observation
    (particle_filter.py:144-154, ``__observation``): every landmark
    expressed in the robot frame of the true pose, plus iid Gaussian noise.

The EKF observation matrix C = [[1,0,0],[0,1,0]]
(extended_kalman_filter.py:47-48) and its Jacobian jH == C
(extended_kalman_filter.py:196-205) are trivial constants; filters embed
them directly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slamsim.core.precision import highest_matmul_precision
from slamsim.core.se2 import robot_to_world, world_to_robot


@highest_matmul_precision
def position_observation(key, pose_true, r_chol):
    """Noisy (x, y) observation of the true pose, noise in the robot frame.

    Parity: extended_kalman_filter.py:100-101,132-146.

    Args:
        key: PRNG key.
        pose_true: ``(..., 3)`` true poses.
        r_chol: ``(2, 2)`` Cholesky factor of the observation covariance
            R_act (lower-triangular), so noise = r_chol @ n, n ~ N(0, I).

    Returns:
        ``(..., 2)`` world-frame observations.
    """
    pose_true = jnp.asarray(pose_true)
    batch_shape = pose_true.shape[:-1]
    n = jax.random.normal(key, batch_shape + (2,), dtype=pose_true.dtype)
    w = jnp.einsum("ij,...j->...i", r_chol, n)
    return robot_to_world(pose_true, w[..., None, :])[..., 0, :]


@highest_matmul_precision
def landmark_observation(key, pose_true, landmarks, r_chol):
    """All landmarks in the true pose's robot frame, plus Gaussian noise.

    Parity: particle_filter.py:144-154.

    Args:
        key: PRNG key.
        pose_true: ``(..., 3)`` true poses.
        landmarks: ``(L, 2)`` world-frame landmark positions.
        r_chol: ``(2, 2)`` Cholesky factor of the per-landmark observation
            covariance R.

    Returns:
        ``(..., L, 2)`` robot-frame noisy landmark observations.
    """
    pose_true = jnp.asarray(pose_true)
    landmarks = jnp.asarray(landmarks)
    z = world_to_robot(pose_true, landmarks)
    n = jax.random.normal(key, z.shape, dtype=z.dtype)
    return z + jnp.einsum("ij,...j->...i", r_chol, n)
