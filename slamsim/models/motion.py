"""Velocity motion model (Probabilistic Robotics ch. 5), batched + jittable.

Capability parity with the reference's ``motion_model.py:14-86``
(``MotionModel.moveWithNoise`` / ``moveWithoutNoise``): exact circular-arc
integration of a unicycle under commanded (v, w) with six noise parameters
a1..a6 controlling the translational / rotational / final-heading noise.

Reference quirks, each behind an explicit config flag (default = reproduce):
  * ``sigma_squared_std`` - motion_model.py:46-48 passes the *squared*
    sigma as the std-dev argument of ``np.random.normal``, so the effective
    std is sigma**2.  True by default for distributional parity.
  * ``omega_guard`` - motion_model.py:50,73 divides by omega with no
    straight-line guard (w == 0 is a ZeroDivisionError in the reference).
    With the guard on (default) the w -> 0 limit (pure translation) is taken
    analytically via the small-angle form, which is *identical* for every
    w != 0 and finite at w == 0, strictly extending the reference.

Design: the model is a pure function of ``(cfg, key, pose, v, w)``
with explicit PRNG; poses are ``(..., 3)`` so one call propagates an entire
batch of rollouts (the reference mutates one (3,1) pose per call).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from slamsim.core.angles import wrap_angle


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Static, hashable motion-model configuration.

    ``a1..a6`` follow the reference's constructor ordering
    (motion_model.py:20-29): (a1, a2) scale translational noise, (a3, a4)
    rotational noise, (a5, a6) final-heading (gamma) noise; each sigma is
    ``a_odd * v^2 + a_even * w^2`` (motion_model.py:43-45).
    """

    dt: float
    a1: float = 0.1
    a2: float = 0.1
    a3: float = 0.1
    a4: float = 0.1
    a5: float = 0.1
    a6: float = 0.1
    sigma_squared_std: bool = True
    omega_guard: bool = True
    omega_eps: float = 1e-7


def noise_sigmas(cfg: MotionConfig, v, w):
    """Per-command noise scales (sigma_v, sigma_w, sigma_gamma).

    Parity: motion_model.py:43-45.  When ``cfg.sigma_squared_std`` the
    returned values are squared before use as std-devs, reproducing
    motion_model.py:46-48.
    """
    v2 = jnp.square(v)
    w2 = jnp.square(w)
    sv = cfg.a1 * v2 + cfg.a2 * w2
    sw = cfg.a3 * v2 + cfg.a4 * w2
    sg = cfg.a5 * v2 + cfg.a6 * w2
    if cfg.sigma_squared_std:
        sv, sw, sg = jnp.square(sv), jnp.square(sw), jnp.square(sg)
    return sv, sw, sg


def _arc_step(pose, v, w, dt, guard: bool, eps: float):
    """Exact circular-arc update shared by the noisy/noiseless paths.

    Parity: motion_model.py:50-56 and :73-80.  ``guard`` switches in the
    analytic w->0 limit (v*dt translation along the heading) instead of the
    reference's division by zero.
    """
    yaw = pose[..., 2]
    b = w * dt
    sin0, cos0 = jnp.sin(yaw), jnp.cos(yaw)
    sin1, cos1 = jnp.sin(yaw + b), jnp.cos(yaw + b)
    if guard:
        w_safe = jnp.where(jnp.abs(w) < eps, eps, w)
        a = v / w_safe
        dx_arc = a * (sin1 - sin0)
        dy_arc = a * (cos0 - cos1)
        dx = jnp.where(jnp.abs(w) < eps, v * dt * cos0, dx_arc)
        dy = jnp.where(jnp.abs(w) < eps, v * dt * sin0, dy_arc)
    else:
        a = v / w
        dx = a * (sin1 - sin0)
        dy = a * (cos0 - cos1)
    return dx, dy


def motion_sample_with_noise(cfg: MotionConfig, pose, v, w, unit_noise):
    """Deterministic-input twin of :func:`motion_sample`: the three
    standard-normal draws are supplied by the caller.

    ``unit_noise`` is ``(..., 3)`` unit draws for (v_hat, w_hat,
    gamma_hat); they are scaled by :func:`noise_sigmas` exactly as
    ``moveWithNoise`` scales its ``np.random.normal(0, sigma**2)`` draws
    (motion_model.py:46-48).  Used to replay recorded reference noise
    streams (tests/test_reference_exec.py)."""
    pose = jnp.asarray(pose)
    sv, sw, sg = noise_sigmas(cfg, v, w)
    v_hat = v + unit_noise[..., 0] * sv
    w_hat = w + unit_noise[..., 1] * sw
    g_hat = unit_noise[..., 2] * sg
    dx, dy = _arc_step(pose, v_hat, w_hat, cfg.dt, cfg.omega_guard,
                       cfg.omega_eps)
    yaw_new = wrap_angle(pose[..., 2] + (w_hat + g_hat) * cfg.dt)
    return jnp.stack(
        [pose[..., 0] + dx, pose[..., 1] + dy, yaw_new], axis=-1)


def motion_sample(cfg: MotionConfig, key, pose, v, w):
    """One noisy motion step (parity: motion_model.py:31-62, moveWithNoise).

    Args:
        cfg: static motion configuration.
        key: PRNG key; consumed for the (v_hat, w_hat, gamma_hat) draws.
        pose: ``(..., 3)`` poses ``[x, y, yaw]``.
        v, w: commanded velocity [m/s] / yaw rate [rad/s]; scalars or
            broadcastable to ``pose``'s batch shape.

    Returns:
        ``(..., 3)`` propagated poses.
    """
    pose = jnp.asarray(pose)
    batch_shape = pose.shape[:-1]
    noise = jax.random.normal(key, batch_shape + (3,), dtype=pose.dtype)
    return motion_sample_with_noise(cfg, pose, v, w, noise)


def motion_mean(cfg: MotionConfig, pose, v, w):
    """Noiseless motion step (parity: motion_model.py:64-86).

    The reference wraps ``w*dt`` and ``yaw + w*dt`` through limit_angle
    before taking sin/cos (motion_model.py:74-76); wrapping does not change
    the trig values, and the returned yaw is wrapped identically here.
    """
    pose = jnp.asarray(pose)
    dx, dy = _arc_step(pose, v, w, cfg.dt, cfg.omega_guard, cfg.omega_eps)
    yaw_new = wrap_angle(pose[..., 2] + w * cfg.dt)
    return jnp.stack(
        [pose[..., 0] + dx, pose[..., 1] + dy, yaw_new], axis=-1)
