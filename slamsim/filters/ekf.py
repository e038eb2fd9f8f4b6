"""Extended Kalman filter localization in JAX.

Capability parity with the reference's ``ExtendedKalmanFilter``
(extended_kalman_filter.py:17-205): circular-motion process model,
GPS-like position observation with robot-frame noise, analytic Jacobians,
standard (non-Joseph) covariance update, and the fused
sim+filter step ``main_ekf`` (extended_kalman_filter.py:86-130).

Redesign for batched devices:
  * The reference fuses ground-truth simulation and filtering inside one
    stateful method; here they are separate pure functions -
    :func:`ekf_predict` / :func:`ekf_update` are the filter,
    :func:`ekf_step` composes sim + filter exactly like ``main_ekf`` for
    demo/fidelity parity.
  * State is a pytree (:class:`EkfState`); config is a static hashable
    dataclass, so ``jax.jit(ekf_step, static_argnums=0)`` compiles once.
  * :func:`ekf_rollout` drives the step under ``lax.scan`` (replacing
    matplotlib ``FuncAnimation`` as the simulation driver,
    extended_kalman_filter.py:286) and returns device-resident trajectory
    buffers; vmap it over keys for Monte-Carlo sweeps.
  * The 2x2 innovation-covariance inverse is analytic - no
    ``np.linalg.inv`` (extended_kalman_filter.py:157) and nothing for XLA
    to call out of line.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import jax
import jax.numpy as jnp

from slamsim.core.angles import wrap_angle
from slamsim.core.precision import highest_matmul_precision
from slamsim.core.se2 import robot_to_world
from slamsim.models.process import circular_jacobian, circular_step


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """Static EKF configuration; defaults = reference values.

    Stds are stored (not covariances); covariance = diag(std)^2, matching
    extended_kalman_filter.py:50-72.  ``q_yaw_std_deg`` keeps the
    reference's quirk of specifying the yaw std in degrees
    (extended_kalman_filter.py:54).
    """

    dt: float = 0.1  # period_ms=100 (extended_kalman_filter.py:278)
    radius_m: float = 10.0  # __RADIUS_m (:32)
    yaw_rate: float = math.radians(10.0)  # __YAW_RATE_rps (:33)
    # Filter noise model (:52-60)
    q_std: tuple = (0.1, 0.1, math.radians(0.1))
    r_std: tuple = (1.0, 1.0)
    # Simulation ("actual") noise (:64-72); defaults equal the filter's.
    q_act_std: tuple = (0.1, 0.1, math.radians(0.1))
    r_act_std: tuple = (1.0, 1.0)
    # Initial state (:74-84)
    x0: tuple = (10.0, 0.0, math.pi / 2.0)
    p0_std: tuple = (0.01, 0.01, math.radians(30.0))

    @property
    def vel(self) -> float:
        """Commanded velocity = radius * yaw_rate (:34)."""
        return self.radius_m * self.yaw_rate


class EkfState(typing.NamedTuple):
    """Filter + simulation state pytree (leading dims = batch)."""

    x_true: jax.Array  # (..., 3) ground truth
    x_dr: jax.Array  # (..., 3) dead reckoning
    x_hat: jax.Array  # (..., 3) posterior estimate
    cov: jax.Array  # (..., 3, 3) posterior covariance


class EkfOut(typing.NamedTuple):
    """Per-step outputs, mirroring main_ekf's returns (:130)."""

    x_true: jax.Array
    x_dr: jax.Array
    z: jax.Array  # (..., 2) observation
    x_pre: jax.Array  # (..., 3) prior (pre-update) estimate
    cov: jax.Array  # (..., 3, 3) posterior covariance


def _diag_sq(std: tuple) -> jax.Array:
    s = jnp.asarray(std)
    return jnp.diag(s * s)


def ekf_init(cfg: EkfConfig, batch_shape: tuple = ()) -> EkfState:
    """Initial state (parity: extended_kalman_filter.py:74-84)."""
    x0 = jnp.broadcast_to(jnp.asarray(cfg.x0), batch_shape + (3,))
    p0 = jnp.broadcast_to(_diag_sq(cfg.p0_std), batch_shape + (3, 3))
    return EkfState(x_true=x0, x_dr=x0, x_hat=x0, cov=p0)


@highest_matmul_precision
def ekf_predict(cfg: EkfConfig, x_hat, cov):
    """EKF prediction (parity: extended_kalman_filter.py:109-115).

    Returns (x_prior, cov_prior).
    """
    x_pre = circular_step(x_hat, cfg.vel, cfg.yaw_rate, cfg.dt)
    f_jac = circular_jacobian(x_hat, cfg.vel, cfg.dt)
    q = _diag_sq(cfg.q_std)
    cov_pre = jnp.einsum("...ij,...jk,...lk->...il", f_jac, cov, f_jac) + q
    return x_pre, cov_pre


def _inv2x2(m):
    """Analytic batched 2x2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv = jnp.stack([
        jnp.stack([d, -b], axis=-1),
        jnp.stack([-c, a], axis=-1),
    ], axis=-2)
    return inv / det[..., None, None]


@highest_matmul_precision
def ekf_update(cfg: EkfConfig, x_pre, cov_pre, z):
    """EKF measurement update (parity: extended_kalman_filter.py:117-128).

    H = [[1,0,0],[0,1,0]] (``__jacobH``, :196-205); gain
    G = P- H^T (H P- H^T + R)^-1 (``__calc_kalman_gain``, :148-158); the
    posterior covariance uses the standard form (I - G H) P-, not Joseph.

    Returns (x_post, cov_post).
    """
    r = _diag_sq(cfg.r_std)
    # H x = x[:2]; H P- H^T = P-[0:2, 0:2]; P- H^T = P-[:, 0:2].
    innov = z - x_pre[..., :2]
    s = cov_pre[..., :2, :2] + r
    gain = jnp.einsum("...ij,...jk->...ik", cov_pre[..., :, :2], _inv2x2(s))
    x_post = x_pre + jnp.einsum("...ij,...j->...i", gain, innov)
    x_post = x_post.at[..., 2].set(wrap_angle(x_post[..., 2]))
    cov_post = cov_pre - jnp.einsum(
        "...ij,...jk->...ik", gain, cov_pre[..., :2, :])
    return x_post, cov_post


def ekf_step_with_noise(cfg: EkfConfig, state: EkfState, obs_noise,
                        dr_noise):
    """Deterministic-input fused step: noise vectors supplied by the caller.

    This is the fidelity-testable core of :func:`ekf_step`: given the same
    noise draws, the trajectory matches a NumPy re-implementation of the
    reference to float tolerance (RNG streams themselves cannot be
    bit-matched across numpy MT19937 and JAX threefry).

    Args:
        obs_noise: ``(..., 2)`` robot-frame observation noise ``w``
            (already scaled by R_act's Cholesky; :100).
        dr_noise: ``(..., 3)`` additive dead-reckoning noise ``v`` (already
            scaled by Q_act's Cholesky; :105).
    """
    # Ground truth (:97).
    x_true = circular_step(state.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)

    # Observation with robot-frame noise rotated to world (:100-101,132-146).
    z = robot_to_world(x_true, obs_noise[..., None, :])[..., 0, :]

    # Dead reckoning with additive Q_act noise (:104-106).
    x_dr = circular_step(state.x_dr, cfg.vel, cfg.yaw_rate,
                         cfg.dt) + dr_noise

    # Filter.
    x_pre, cov_pre = ekf_predict(cfg, state.x_hat, state.cov)
    x_post, cov_post = ekf_update(cfg, x_pre, cov_pre, z)

    next_state = EkfState(x_true=x_true, x_dr=x_dr, x_hat=x_post,
                          cov=cov_post)
    out = EkfOut(x_true=x_true, x_dr=x_dr, z=z, x_pre=x_pre, cov=cov_post)
    return next_state, out


def ekf_step(cfg: EkfConfig, state: EkfState, key):
    """One fused sim+filter step (parity: main_ekf, :86-130).

    Order matches the reference exactly: propagate truth; sample the
    observation; dead-reckon with Q_act noise; predict; update.

    Args:
        cfg: static config.
        state: current :class:`EkfState` (batched ok).
        key: PRNG key (one per step; internally split).

    Returns:
        ``(next_state, EkfOut)``.
    """
    k_obs, k_dr = jax.random.split(key)
    batch_shape = state.x_true.shape[:-1]
    dtype = state.x_true.dtype
    obs_noise = jax.random.normal(
        k_obs, batch_shape + (2,), dtype=dtype) * jnp.asarray(cfg.r_act_std)
    dr_noise = jax.random.normal(
        k_dr, batch_shape + (3,), dtype=dtype) * jnp.asarray(cfg.q_act_std)
    return ekf_step_with_noise(cfg, state, obs_noise, dr_noise)


def ekf_rollout(cfg: EkfConfig, key, n_steps: int,
                state0: EkfState | None = None):
    """Run ``n_steps`` EKF steps under ``lax.scan``.

    Replaces the reference's per-frame FuncAnimation driver
    (extended_kalman_filter.py:286) with a single compiled scan; outputs
    stay on device as ``(n_steps, ...)`` buffers for the renderer or the
    metrics reducers.

    All noise is drawn in two bulk threefry calls up front and scanned
    over (per-step key splitting dominates the scan otherwise); the
    stream differs from per-step :func:`ekf_step` draws but is
    distributionally identical.

    Returns:
        ``(final_state, outs)`` where each field of ``outs`` is stacked
        along a leading time axis.
    """
    if state0 is None:
        state0 = ekf_init(cfg)
    k_obs, k_dr = jax.random.split(key)
    batch_shape = state0.x_true.shape[:-1]
    dtype = state0.x_true.dtype
    obs_noise = jax.random.normal(
        k_obs, (n_steps,) + batch_shape + (2,),
        dtype=dtype) * jnp.asarray(cfg.r_act_std)
    dr_noise = jax.random.normal(
        k_dr, (n_steps,) + batch_shape + (3,),
        dtype=dtype) * jnp.asarray(cfg.q_act_std)

    def body(s, noise):
        return ekf_step_with_noise(cfg, s, noise[0], noise[1])

    return jax.lax.scan(body, state0, (obs_noise, dr_noise))


def ekf_rollout_batch(cfg: EkfConfig, keys, n_steps: int):
    """Monte-Carlo sweep: vmapped :func:`ekf_rollout` over a key batch.

    ``keys`` is ``(B,)`` PRNG keys -> every output gains a leading batch
    axis.  This is BASELINE config 3 (8192 noise-seeded rollouts on one
    chip) before sharding; see ``slamsim.parallel`` for the mesh version.
    """
    return jax.vmap(lambda k: ekf_rollout(cfg, k, n_steps))(keys)
