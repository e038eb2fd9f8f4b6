"""Sector-FOV landmark scan sensor, fixed-shape + masked, batched + keyed.

Capability parity with the reference's ``ScanSensor``
(graph_based_slam.py:73-259): a range/bearing/orientation landmark sensor
with a sector field of view about the robot's forward (+y at yaw=pi/2) axis,
range-proportional distance noise, and Gaussian bearing/orientation noise.
"Orientation" is the observed heading of the world +y axis in the robot
frame: ``BASE_ANG - robot_yaw`` (graph_based_slam.py:153) - effectively a
compass reading attached to each sighting.

Redesign for batched devices: where the reference returns variable-length Python lists
of ``Observation`` objects (graph_based_slam.py:148-172), :func:`scan`
returns fixed ``(..., L)`` arrays ``(dist, bearing, orient)`` plus a boolean
``valid`` mask.  This is the masking decision that makes every downstream
consumer (graph-SLAM pairing, H assembly) jit-compatible with static shapes.

Noise parameters live in a static hashable :class:`ScanConfig` (the
reference mutates *class-level* defaults via ``setNoiseParam``,
graph_based_slam.py:115-126; here a new config value simply recompiles).
"""

from __future__ import annotations

import dataclasses
import math
import typing

import jax
import jax.numpy as jnp

from slamsim.core.angles import wrap_angle
from slamsim.core.precision import highest_matmul_precision
from slamsim.core.se2 import BASE_ANG, world_to_robot


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Static scan-sensor configuration.

    Defaults mirror the reference class-level noise defaults
    (graph_based_slam.py:78-81); the graph-SLAM demo overrides them to
    (5%, 2deg, 2deg) via ``setNoiseParam`` (graph_based_slam.py:604).
    """

    range_m: float = 15.0
    angle_rad: float = math.radians(80.0)
    #: distance noise std = dist * dist_gain (graph_based_slam.py:79,165)
    dist_gain: float = 10.0 / 100.0
    dir_sigma: float = math.radians(3.0)
    orient_sigma: float = math.radians(3.0)


class Scan(typing.NamedTuple):
    """Fixed-shape scan result; each field is ``(..., L)``."""

    dist: jax.Array
    bearing: jax.Array
    orient: jax.Array
    valid: jax.Array  # bool; False entries are geometric truth w/o noise


def scan_true(cfg: ScanConfig, pose, landmarks):
    """Noise-free scan: (dist, bearing, orient, valid) for every landmark.

    Parity: graph_based_slam.py:150-160 (geometry + FOV test).  The FOV
    test keeps landmark i iff ``dist_i <= range`` and, in the robot frame,
    ``y_i >= |x_i| * tan(BASE_ANG - scan_angle)`` - a sector about the
    robot's forward (+y) axis of half-angle ``scan_angle``.

    Args:
        cfg: static sensor config.
        pose: ``(..., 3)`` robot poses.
        landmarks: ``(L, 2)`` world-frame landmarks.

    Returns:
        :class:`Scan` with ``(..., L)`` fields.
    """
    pose = jnp.asarray(pose)
    lm_r = world_to_robot(pose, jnp.asarray(landmarks))  # (..., L, 2)
    x, y = lm_r[..., 0], lm_r[..., 1]
    dist = jnp.sqrt(x * x + y * y)
    bearing = jnp.arctan2(y, x)
    orient = wrap_angle(BASE_ANG - pose[..., 2])[..., None] * jnp.ones_like(x)
    sector = y >= jnp.abs(x) * math.tan(BASE_ANG - cfg.angle_rad)
    valid = (dist <= cfg.range_m) & sector
    return Scan(dist, bearing, orient, valid)


def scan(cfg: ScanConfig, key, pose, landmarks):
    """Noisy + noise-free scan of all landmarks.

    Parity: graph_based_slam.py:128-172 (``ScanSensor.scan``): distance
    noise std is range-proportional (``dist * dist_gain``), bearing and
    orientation noise are Gaussian and wrapped.

    Returns:
        ``(noisy, true)`` pair of :class:`Scan`; both share the same
        ``valid`` mask (computed from the true geometry, as in the
        reference where detection happens before noise is applied).
    """
    true = scan_true(cfg, pose, landmarks)
    n = jax.random.normal(key, true.dist.shape + (3,), dtype=true.dist.dtype)
    return scan_apply_noise(cfg, true, n), true


def scan_apply_noise(cfg: ScanConfig, true: Scan, unit_noise) -> Scan:
    """Apply the reference's sighting noise law to a noise-free scan.

    ``unit_noise`` is ``(..., L, 3)`` standard-normal draws for
    (dist, bearing, orient); the law matches ``ScanSensor.scan``
    (graph_based_slam.py:164-167): distance std is range-proportional,
    bearing/orientation are Gaussian and wrapped.  Split out so recorded
    reference draws can be replayed (tests/test_reference_exec.py)."""
    n = unit_noise
    dist_n = true.dist + n[..., 0] * true.dist * cfg.dist_gain
    bear_n = wrap_angle(true.bearing + n[..., 1] * cfg.dir_sigma)
    orient_n = wrap_angle(true.orient + n[..., 2] * cfg.orient_sigma)
    return Scan(dist_n, bear_n, orient_n, true.valid)


def measurement_cov(cfg: ScanConfig, dist):
    """3x3 sighting covariance in the measurement frame, batched over dist.

    Parity: graph_based_slam.py:175-194
    (``getLandMarkCovMatrixOnMeasurementSys``):
    diag((d*gain)^2, (d*sin(dir_sigma))^2, dir_sigma^2 + orient_sigma^2).

    Args:
        dist: ``(...)`` landmark distances.

    Returns:
        ``(..., 3, 3)`` diagonal covariances.
    """
    dist = jnp.asarray(dist)
    dd = jnp.square(dist * cfg.dist_gain)
    dc = jnp.square(dist * math.sin(cfg.dir_sigma))
    oc = jnp.full_like(dist, cfg.dir_sigma ** 2 + cfg.orient_sigma ** 2)
    z = jnp.zeros_like(dist)
    return jnp.stack([
        jnp.stack([dd, z, z], axis=-1),
        jnp.stack([z, dc, z], axis=-1),
        jnp.stack([z, z, oc], axis=-1),
    ], axis=-2)


@highest_matmul_precision
def _rot_z_cov(cov, ang):
    """Rotate ``(..., 3, 3)`` covariances about z by ``ang`` (batched)."""
    c, s = jnp.cos(ang), jnp.sin(ang)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    rot = jnp.stack([
        jnp.stack([c, -s, z], axis=-1),
        jnp.stack([s, c, z], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ], axis=-2)
    return jnp.einsum("...ij,...jk,...lk->...il", rot, cov, rot)


def cov_measurement_to_world(cov, lm_bearing, robot_yaw):
    """Rotate a measurement-frame covariance into the world frame.

    Parity: graph_based_slam.py:196-215 (``tfMeasurement2World``);
    rotation angle = bearing + robot_yaw - BASE_ANG.
    """
    return _rot_z_cov(cov, lm_bearing + robot_yaw - BASE_ANG)


def cov_measurement_to_robot(cov, lm_bearing):
    """Rotate a measurement-frame covariance into the robot frame.

    Parity: graph_based_slam.py:218-234 (``tfMeasurement2Robot``);
    rotation angle = bearing.
    """
    return _rot_z_cov(cov, lm_bearing)
