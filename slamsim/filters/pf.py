"""Particle filter localization in JAX.

Capability parity with the reference's ``ParticleFilter``
(particle_filter.py:18-237): the same circular process model, five fixed
landmarks observed in the robot frame, likelihood = product over landmarks
of a bivariate normal pdf on the robot-frame discrepancy, ESS-gated
systematic (low-variance) resampling, and a maximum-a-posteriori particle
estimate (argmax weight - NOT the weighted mean, particle_filter.py:115-117).

Redesign for batched devices:
  * Particles are a ``(NP, 3)`` array; the likelihood is a single vmapped
    frame-transform + Gaussian product (the reference loops per particle in
    Python, particle_filter.py:185-192 - the hot spot of its PF demo).
  * ``matplotlib.mlab.bivariate_normal`` (removed from modern matplotlib;
    particle_filter.py:191) is reimplemented in closed form, including the
    correlated case the reference parameterizes via sigma_xy.
  * Resampling replaces the sequential index walk
    (particle_filter.py:218-221) with cumsum + searchsorted + gather under
    ``lax.cond`` on the ESS gate - identical selection, O(N log N), fully
    vectorized for 100 -> 100k+ particles (BASELINE config 2).
  * NaN-weight recovery (particle_filter.py:236) is a ``jnp.where`` reset
    to uniform, preserved as a first-class divergence guard.  An optional
    log-space weight path avoids the underflow that triggers it at scale.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import jax
import jax.numpy as jnp

from slamsim.core.precision import highest_matmul_precision
from slamsim.core.se2 import world_to_robot
from slamsim.models.process import circular_step

#: Reference landmark table (particle_filter.py:39-43).
REF_LANDMARKS = ((5.0, 5.0), (2.0, -3.0), (-3.0, 4.0), (-5.0, -1.0),
                 (0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class PfConfig:
    """Static PF configuration; defaults = reference values.

    ``ess_threshold_frac`` expresses the reference's ESS gate
    ``ESS < NP/100`` (particle_filter.py:33,211) as a fraction of NP so it
    scales with particle count.
    """

    dt: float = 0.1  # period_ms=100 (particle_filter.py:333)
    num_particles: int = 1000  # __NP (:31)
    radius_m: float = 10.0  # (:46)
    yaw_rate: float = math.radians(10.0)  # (:47)
    landmarks: tuple = REF_LANDMARKS
    # System noise stds (:62-65); yaw std given in degrees in the reference.
    q_std: tuple = (0.03, 0.03, math.radians(2.0))
    # Observation noise stds (:68-70).
    r_std: tuple = (0.3, 0.3)
    ess_threshold_frac: float = 1.0 / 100.0  # (:33)
    x0: tuple = (10.0, 0.0, math.pi / 2.0)  # (:74-79)
    #: "map" = argmax-weight particle (reference, :115-117); "mean" =
    #: weighted mean with circular yaw averaging.
    estimate: str = "map"
    #: "linear" reproduces the reference's raw pdf products (can underflow
    #: -> NaN reset, like the reference); "log" computes weights in log
    #: space with logsumexp normalization (preferred at large NP).
    weight_mode: str = "linear"
    #: "search" = searchsorted comb (reference-exact selection); "hist" =
    #: the same comb decoded from quantized slot intervals (see
    #: systematic_resample).
    resample_method: str = "search"

    @property
    def vel(self) -> float:
        return self.radius_m * self.yaw_rate


class PfState(typing.NamedTuple):
    x_true: jax.Array  # (..., 3)
    particles: jax.Array  # (..., NP, 3)
    weights: jax.Array  # (..., NP) normalized


class PfOut(typing.NamedTuple):
    x_true: jax.Array
    x_est: jax.Array  # (..., 3)
    particles: jax.Array
    weights: jax.Array
    max_idx: jax.Array  # argmax-weight index (reference returns it, :116)
    max_w: jax.Array
    ess: jax.Array  # effective sample size before resampling
    resampled: jax.Array  # bool


def pf_init(cfg: PfConfig, batch_shape: tuple = ()) -> PfState:
    """All particles at x0 with uniform weights (particle_filter.py:77-84)."""
    x0 = jnp.broadcast_to(jnp.asarray(cfg.x0), batch_shape + (3,))
    particles = jnp.broadcast_to(
        jnp.asarray(cfg.x0), batch_shape + (cfg.num_particles, 3))
    weights = jnp.full(batch_shape + (cfg.num_particles,),
                       1.0 / cfg.num_particles)
    return PfState(x_true=x0, particles=particles, weights=weights)


def bivariate_normal_pdf(dx, dy, sigma_x, sigma_y, sigma_xy=0.0):
    """Closed-form bivariate normal pdf.

    Drop-in replacement for the removed ``matplotlib.mlab.bivariate_normal``
    the reference calls at particle_filter.py:191 (with mux=muy=0 folded
    into dx, dy).  ``sigma_xy`` is the covariance (the reference passes
    ``sqrt(R[0][1]) = 0``).
    """
    rho = sigma_xy / (sigma_x * sigma_y)
    one_m_rho2 = 1.0 - rho * rho
    zx = dx / sigma_x
    zy = dy / sigma_y
    expo = (zx * zx + zy * zy - 2.0 * rho * zx * zy) / (2.0 * one_m_rho2)
    norm = 2.0 * jnp.pi * sigma_x * sigma_y * jnp.sqrt(one_m_rho2)
    return jnp.exp(-expo) / norm


def quantized_cum(weights):
    """Exact-integer weight cumsum for interval-based selection.

    Weights are scaled to integer multiples of ``2^-20`` of their total;
    integer partial sums below ``2^24`` are exact in f32 in ANY
    summation order, so the cumsum is provably non-decreasing and the
    exclusive prefix equals the previous inclusive prefix exactly - the
    invariants the interval decode ("hist") relies on.  A raw f32
    cumsum does not guarantee either (XLA's scan lowering may combine
    partial sums in element-dependent orders).  Weights below ``2^-21`` of the total quantize to zero
    slots - a <= 2^-20 relative perturbation of the selection law.

    Returns ``(cum, total)`` in the input dtype.
    """
    total_w = jnp.sum(weights, axis=-1, keepdims=True)
    wq = quantize_weights_law(weights, total_w)
    cum = jnp.cumsum(wq, axis=-1)
    return cum, cum[..., -1:]


def quantize_weights_law(weights, total):
    """THE interval-resample quantization: integers of ``2^-20 * total``.

    Single source of the scale/rounding expression of every interval
    decode; the exact-integer monotonicity the slot partition depends on
    requires all of them to quantize with literally this expression.
    """
    return jnp.round(weights * (float(1 << 20) / total))


def boundary_law(cum, inv_tot, n, offs):
    """THE slot-boundary law: ``t = ceil(n * (cum * inv_tot) - offs)``.

    ``inv_tot`` is the reciprocal of the quantized total, computed ONCE
    and shared by every decode of the same weights.  The law contains
    multiplies and a subtract only - no division, whose reciprocal and
    refinement steps two compilers may round differently - so every
    evaluation is bit-identical and the boundary is monotone in ``cum``
    (each op is monotone; an fma contraction of ``mul-sub`` is monotone
    too), which the interval decode's no-double-cover property needs.

    Callers clip/force afterwards; ``cum`` must be the exact-integer
    quantized cumsum (:func:`quantized_cum`).
    """
    return jnp.ceil(n * (cum * inv_tot) - offs)


def slot_boundaries(weights, n: int, offs):
    """Slot boundaries of the systematic comb over quantized intervals.

    ``t_j = clip(ceil(n * cum_j - offs), 0, n)`` with ``t`` forced to
    ``n`` from lane ``n - 1`` on: particle ``j`` owns output slots
    ``[t_{j-1}, t_j)``.  ``cum`` is :func:`quantized_cum`, so ``t`` is
    non-decreasing and the intervals partition ``[0, n)``; the forcing
    reproduces the reference's trailing ``clip(idx, 0, n-1)`` (slots
    past the last boundary select particle ``n - 1``).  The "hist"
    decode of :func:`resample_indices_from_offs` selects exactly these
    intervals.

    Args:
        weights: ``(..., n_pad)`` normalized weights, padded lanes zero.
        n: valid particle count.
        offs: scalar comb offset in units of ``1/n``.

    Returns:
        ``(..., n_pad)`` int32 boundaries in ``[0, n]``.
    """
    cumq, q_tot = quantized_cum(weights.astype(jnp.float32))
    t = boundary_law(cumq, 1.0 / q_tot, n, offs).astype(jnp.int32)
    t = jnp.clip(t, 0, n)
    lane = jax.lax.broadcasted_iota(jnp.int32, t.shape, t.ndim - 1)
    return jnp.where(lane >= n - 1, n, t)


def resample_indices(key, weights, method: str = "search"):
    """Systematic-resampling index selection (see
    :func:`systematic_resample`); returns the ``(N,)`` gather indices."""
    offs = jax.random.uniform(key, dtype=weights.dtype)  # in units of 1/n
    return resample_indices_from_offs(offs, weights, method)


def resample_indices_from_offs(offs, weights, method: str = "search"):
    """Deterministic-input twin of :func:`resample_indices`: the comb
    offset ``offs`` (uniform in [0, 1), in units of ``1/N`` - the
    reference's ``np.random.rand()`` at particle_filter.py:214) is
    supplied by the caller instead of drawn from a key.  Used for replay
    against recorded reference noise streams."""
    n = weights.shape[-1]
    if method not in ("search", "hist"):
        raise ValueError(f"unknown resample method {method!r}")
    if method == "hist":
        cumq, q_tot = quantized_cum(weights)
        inv_tot = 1.0 / q_tot
        # t_j = ceil(n * cum_j - offs); out_idx[i] = #{j : t_j <= i}
        #     = searchsorted(cum, (i + offs)/n, 'left') for float-generic
        # inputs.  Computed as a LAST-OCCURRENCE scatter + forward-fill
        # running max: out_idx[i] = max over v <= i of (1 + last j with
        # t_j = v), zero where no t <= i.  Numerically identical to the
        # histogram+cumsum formulation, but the scatter has UNIQUE
        # indices (one per distinct t value), so no colliding
        # scatter-add has to serialize its duplicates.
        t = boundary_law(cumq, inv_tot, n, offs).astype(jnp.int32)
        t = jnp.clip(t, 0, n)
        last = jnp.concatenate([t[:-1] != t[1:], jnp.ones((1,), bool)])
        tgt = jnp.where(last, t, n)  # non-last duplicates / t==n dropped
        sparse = jnp.zeros((n,), jnp.int32).at[tgt].set(
            jnp.arange(1, n + 1, dtype=jnp.int32), mode="drop",
            unique_indices=True)
        idx = jax.lax.associative_scan(jnp.maximum, sparse)
    else:
        cum = jnp.cumsum(weights, axis=-1)
        u = (jnp.arange(n, dtype=weights.dtype) + offs) / n
        idx = jnp.searchsorted(cum, u, side="left")
    return jnp.clip(idx, 0, n - 1)


def systematic_resample(key, particles, weights, method: str = "search"):
    """Low-variance systematic resampling, vectorized.

    Selection is identical to the reference's sequential comb walk
    (particle_filter.py:212-221): positions u_i = i/N + U(0, 1/N); particle
    index = first j with cumsum(w)[j] >= u_i.

    Args:
        method: ``"search"`` uses ``searchsorted`` (reference-exact index
            selection).  ``"hist"`` exploits that the comb positions are
            an ascending uniform grid: each particle j captures the
            output slots in ``[ceil(N*cum_{j-1} - offs), ceil(N*cum_j -
            offs))``, so the index map is a scatter-histogram + cumsum -
            O(N) with no binary-search gather chains
            (selection can differ from "search" only when a comb point
            lands exactly on a cumsum value, a float-measure-zero event).

    Returns:
        (particles_resampled, uniform_weights).
    """
    n = weights.shape[-1]
    idx = resample_indices(key, weights, method)
    return particles[..., idx, :], jnp.full_like(weights, 1.0 / n)


def effective_sample_size(weights):
    """ESS = 1 / sum(w^2) (particle_filter.py:210)."""
    return 1.0 / jnp.sum(jnp.square(weights), axis=-1)


def pf_likelihood(cfg: PfConfig, particles, z):
    """Per-particle likelihood of the landmark observation.

    Parity: particle_filter.py:170-198 (``__likelihood``) - for each
    particle, transform all landmarks into its frame, compare against the
    observed robot-frame landmarks, and take the product over landmarks of
    the bivariate normal pdf.  One vmapped transform replaces the
    reference's per-particle Python loop.

    Args:
        particles: ``(NP, 3)``.
        z: ``(L, 2)`` observed robot-frame landmarks.

    Returns:
        ``(NP,)`` likelihoods (linear mode) or log-likelihoods (log mode).
    """
    lm = jnp.asarray(cfg.landmarks)
    sx, sy = cfg.r_std
    pz = world_to_robot(particles, lm)  # (NP, L, 2)
    d = pz - z
    if cfg.weight_mode == "log":
        zx = d[..., 0] / sx
        zy = d[..., 1] / sy
        log_pdf = (-0.5 * (zx * zx + zy * zy)
                   - jnp.log(2.0 * jnp.pi * sx * sy))
        return jnp.sum(log_pdf, axis=-1)
    pdf = bivariate_normal_pdf(d[..., 0], d[..., 1], sx, sy)
    return jnp.prod(pdf, axis=-1)


def _normalize(cfg: PfConfig, w):
    """Normalize with NaN->uniform reset (particle_filter.py:226-237)."""
    w = w / jnp.sum(w, axis=-1, keepdims=True)
    return jnp.where(jnp.isnan(w), 1.0 / cfg.num_particles, w)


def weights_from_log(cfg: PfConfig, log_w, lse):
    """Normalized weights from unnormalized log weights and their
    logsumexp, with the NaN->uniform reset of particle_filter.py:226-237
    (the log-space twin of :func:`_normalize`).  The single home of the
    reset predicate for every log-weight path (one device and sharded)."""
    lw_n = log_w - lse
    return jnp.where(jnp.isnan(lw_n) | ~jnp.isfinite(lse),
                     1.0 / cfg.num_particles, jnp.exp(lw_n))


@highest_matmul_precision
def pf_estimate(cfg: PfConfig, particles, weights):
    """Point estimate from the weighted particle set.

    ``map`` (default) = argmax-weight particle, the reference's estimator
    (particle_filter.py:115-117).  ``mean`` = weighted mean with circular
    averaging of yaw.
    """
    if cfg.estimate == "mean":
        xy = jnp.einsum("...n,...ni->...i", weights, particles[..., :2])
        cs = jnp.einsum("...n,...n->...", weights,
                        jnp.cos(particles[..., 2]))
        sn = jnp.einsum("...n,...n->...", weights,
                        jnp.sin(particles[..., 2]))
        return jnp.concatenate([xy, jnp.arctan2(sn, cs)[..., None]], axis=-1)
    idx = jnp.argmax(weights, axis=-1)
    return jnp.take_along_axis(
        particles, idx[..., None, None], axis=-2)[..., 0, :]


def pf_step_with_noise(cfg: PfConfig, state: PfState, resample_offs,
                       pred_noise, obs_noise):
    """Deterministic-input fused step: noise supplied by the caller.

    The fidelity-testable core of :func:`pf_step` (the PF twin of
    :func:`slamsim.filters.ekf.ekf_step_with_noise`): given the same
    draws as the reference's ``main_pf``, the trajectory matches to
    float tolerance (see tests/test_reference_exec.py, which replays
    recorded ``np.random`` streams from the live reference).

    Args:
        resample_offs: scalar comb offset in [0, 1) (units of ``1/NP``;
            particle_filter.py:214's ``np.random.rand()``).  Consumed
            only when the ESS gate fires.
        pred_noise: ``(..., NP, 3)`` additive system noise ``v`` (already
            scaled by Q's Cholesky; particle_filter.py:165).
        obs_noise: ``(..., L, 2)`` additive robot-frame observation noise
            ``w`` (already scaled by R's Cholesky; particle_filter.py:152).
    """
    # Ground truth (:100).
    x_true = circular_step(state.x_true, cfg.vel, cfg.yaw_rate, cfg.dt)

    # ESS-gated systematic resampling (:104, 200-224).
    ess = effective_sample_size(state.weights)
    ess_th = cfg.num_particles * cfg.ess_threshold_frac

    def do_resample(p, w):
        idx = resample_indices_from_offs(resample_offs, w,
                                         cfg.resample_method)
        return p[..., idx, :], jnp.full_like(w, 1.0 / cfg.num_particles)

    particles, weights = jax.lax.cond(
        ess < ess_th, do_resample, lambda p, w: (p, w),
        state.particles, state.weights)
    resampled = ess < ess_th

    # Predict with additive system noise (:107, 156-168).
    particles = circular_step(particles, cfg.vel, cfg.yaw_rate,
                              cfg.dt) + pred_noise

    # Observe (:110, 144-154).
    lm = jnp.asarray(cfg.landmarks)
    z = world_to_robot(x_true, lm) + obs_noise

    # Weight update (:113, 170-198) + normalization (:226-237).
    like = pf_likelihood(cfg, particles, z)
    if cfg.weight_mode == "log":
        lw = jnp.log(weights) + like
        lse = jax.scipy.special.logsumexp(lw, axis=-1, keepdims=True)
        weights = weights_from_log(cfg, lw, lse)
    else:
        weights = _normalize(cfg, weights * like)

    x_est = pf_estimate(cfg, particles, weights)
    max_idx = jnp.argmax(weights, axis=-1)
    max_w = jnp.max(weights, axis=-1)

    next_state = PfState(x_true=x_true, particles=particles, weights=weights)
    out = PfOut(x_true=x_true, x_est=x_est, particles=particles,
                weights=weights, max_idx=max_idx, max_w=max_w, ess=ess,
                resampled=resampled)
    return next_state, out


def pf_step(cfg: PfConfig, state: PfState, key):
    """One fused sim+filter step (parity: main_pf, particle_filter.py:86-119).

    Order matches the reference exactly: propagate truth; ESS-gated
    resample (using the previous step's weights); predict all particles
    with Q noise; observe; weight; normalize; MAP estimate.  Samples the
    three noise inputs and delegates to :func:`pf_step_with_noise`.
    """
    k_rs, k_pred, k_obs = jax.random.split(key, 3)
    dtype = state.particles.dtype
    offs = jax.random.uniform(k_rs, dtype=dtype)
    pred_noise = jax.random.normal(
        k_pred, state.particles.shape, dtype=dtype) * jnp.asarray(cfg.q_std)
    n_lm = len(cfg.landmarks)
    obs_shape = state.x_true.shape[:-1] + (n_lm, 2)
    obs_noise = jax.random.normal(
        k_obs, obs_shape, dtype=dtype) * jnp.asarray(cfg.r_std)
    return pf_step_with_noise(cfg, state, offs, pred_noise, obs_noise)


def pf_rollout(cfg: PfConfig, key, n_steps: int,
               state0: PfState | None = None, keep_particles: bool = False):
    """Run ``n_steps`` PF steps under ``lax.scan``.

    By default per-step particle clouds are dropped from the stacked
    outputs (only summary fields are kept) so a 100k-particle rollout does
    not materialize an (n_steps, NP, 3) buffer; pass
    ``keep_particles=True`` for the renderer.
    """
    if state0 is None:
        state0 = pf_init(cfg)
    keys = jax.random.split(key, n_steps)

    def body(s, k):
        s, out = pf_step(cfg, s, k)
        if not keep_particles:
            out = out._replace(
                particles=jnp.zeros((0,)), weights=jnp.zeros((0,)))
        return s, out

    return jax.lax.scan(body, state0, keys)


def pf_rollout_batch(cfg: PfConfig, keys, n_steps: int):
    """Batch of independent PF rollouts, vmapped over seeds.

    The Monte-Carlo sweep shape for MANY SMALL filters (the reference's
    own 1000-particle scale): ``B`` filters advance in lockstep on one
    chip, so the per-scan-iteration overhead and the resample cost
    amortize over the batch.  Note vmap turns the per-filter ESS gate's
    ``lax.cond`` into a select, so BOTH branches execute each step -
    per-filter results are identical to :func:`pf_rollout`, but the
    resample cost is always paid.

    Args:
        keys: ``(B,)`` PRNG keys.

    Returns:
        ``(final_states, outs)`` with a leading ``B`` axis.
    """
    return jax.vmap(lambda k: pf_rollout(cfg, k, n_steps))(keys)
