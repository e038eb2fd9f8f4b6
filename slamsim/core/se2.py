"""SE(2) world<->robot coordinate transforms, batched.

Capability parity with the reference's ``mylib/transform.py:12-59``
(``world2robot`` / ``robot2world`` with the ``BASE_ANG = pi/2`` heading
convention: the robot's "forward" axis is world +y when yaw = pi/2).

Design differences from the reference:
  * Poses are shape ``(..., 3)`` row vectors ``[x, y, yaw]`` instead of
    ``(3, 1)`` column matrices; points are ``(..., N, 2)``.  Leading batch
    dimensions broadcast, so one call transforms landmarks for every
    particle / rollout at once (the reference loops per particle,
    particle_filter.py:185-192).
  * The 2x2 rotation is unrolled into elementwise multiplies - XLA fuses
    it with neighbors; there is no tiny matmul.
"""

from __future__ import annotations

import jax.numpy as jnp

#: Heading convention offset: robot forward = world +y at yaw = BASE_ANG.
#: (mylib/transform.py:12)
BASE_ANG = jnp.pi / 2.0


def world_to_robot(pose, points):
    """Transform world-frame points into the robot frame.

    Parity: mylib/transform.py:14-36 (``world2robot``).

    Args:
        pose: ``(..., 3)`` robot pose ``[x, y, yaw]`` in the world frame.
        points: ``(..., N, 2)`` world-frame points; batch dims broadcast
            against ``pose``'s.

    Returns:
        ``(..., N, 2)`` robot-frame points.
    """
    pose = jnp.asarray(pose)
    points = jnp.asarray(points)
    yaw = BASE_ANG - pose[..., 2]
    c = jnp.cos(yaw)[..., None]
    s = jnp.sin(yaw)[..., None]
    d = points - pose[..., None, :2]
    dx, dy = d[..., 0], d[..., 1]
    return jnp.stack([c * dx - s * dy, s * dx + c * dy], axis=-1)


def robot_to_world(pose, points):
    """Transform robot-frame points into the world frame.

    Parity: mylib/transform.py:38-59 (``robot2world``); exact inverse of
    :func:`world_to_robot`.

    Args:
        pose: ``(..., 3)`` robot pose ``[x, y, yaw]`` in the world frame.
        points: ``(..., N, 2)`` robot-frame points.

    Returns:
        ``(..., N, 2)`` world-frame points.
    """
    pose = jnp.asarray(pose)
    points = jnp.asarray(points)
    yaw = pose[..., 2] - BASE_ANG
    c = jnp.cos(yaw)[..., None]
    s = jnp.sin(yaw)[..., None]
    px, py = points[..., 0], points[..., 1]
    rx = c * px - s * py
    ry = s * px + c * py
    return jnp.stack([rx, ry], axis=-1) + pose[..., None, :2]
