"""Circular-motion process model shared by the EKF and PF, batched.

Capability parity with the inline ``__f`` state equation of the reference
filters (extended_kalman_filter.py:160-178, particle_filter.py:121-142):

    x(k+1) = A x(k) + B u(k),  A = I3,  B = diag(v, v, w),
    u = (dt cos(yaw), dt sin(yaw), dt)

which expands to the unicycle Euler step
    x += v dt cos(yaw); y += v dt sin(yaw); yaw += w dt (wrapped).

Also provides the analytic Jacobian (extended_kalman_filter.py:180-194).
Pure functions over ``(..., 3)`` pose arrays; no per-particle Python loops
(the reference wraps each particle's yaw in a loop,
particle_filter.py:139-140).
"""

from __future__ import annotations

import jax.numpy as jnp

from slamsim.core.angles import wrap_angle


def circular_step(pose, v, w, dt):
    """Propagate pose(s) one step of the circular process model.

    Parity: extended_kalman_filter.py:160-178 (``__f``).

    Args:
        pose: ``(..., 3)`` poses ``[x, y, yaw]``.
        v: velocity [m/s].
        w: yaw rate [rad/s].
        dt: step [s].

    Returns:
        ``(..., 3)`` next poses with wrapped yaw.
    """
    pose = jnp.asarray(pose)
    yaw = pose[..., 2]
    return jnp.stack([
        pose[..., 0] + v * dt * jnp.cos(yaw),
        pose[..., 1] + v * dt * jnp.sin(yaw),
        wrap_angle(yaw + w * dt),
    ], axis=-1)


def circular_jacobian(pose, v, dt):
    """Analytic Jacobian dF/dx of :func:`circular_step`.

    Parity: extended_kalman_filter.py:180-194 (``__jacobF``):
        [[1, 0, -dt v sin(yaw)], [0, 1, dt v cos(yaw)], [0, 0, 1]].

    Args:
        pose: ``(..., 3)`` poses at which to linearize.

    Returns:
        ``(..., 3, 3)`` Jacobians.
    """
    pose = jnp.asarray(pose)
    yaw = pose[..., 2]
    z = jnp.zeros_like(yaw)
    o = jnp.ones_like(yaw)
    a = -dt * v * jnp.sin(yaw)
    b = dt * v * jnp.cos(yaw)
    rows = jnp.stack([
        jnp.stack([o, z, a], axis=-1),
        jnp.stack([z, o, b], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ], axis=-2)
    return rows
