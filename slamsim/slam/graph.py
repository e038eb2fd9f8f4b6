"""Graph-based SLAM: edge construction, information-matrix assembly,
Gauss-Newton solve.  A redesign of the reference's
``TrajectoryEstimator`` (graph_based_slam.py:331-581) and the pairing loop
of ``Robot.estimateOpticalTrajectory`` (graph_based_slam.py:685-715).

Reference algorithm (SURVEY.md sections 2.12, 3.3): every pair of sightings
of the same landmark at two times yields a pose-pair constraint; the error
is the relative pose implied by the current estimates minus the relative
pose implied by the two observations; constraints are premultiplied into
3x3 blocks J^T.Omega.J / J^T.Omega.e, scatter-added into a dense (3T x 3T)
information matrix H and vector b with a 1e4*I gauge anchor on the first
block (graph_based_slam.py:474-475), guarded by det/cond checks
(graph_based_slam.py:494-496), and solved densely; the Gauss-Newton outer
loop re-linearizes until ||dx||^2 < 0.01.

Redesign decisions:
  * Fixed shapes: observations are padded ``(T1, L)`` tensors with a
    validity mask (no Python half-edge lists); the all-pairs set is a
    static upper-triangular index table, masked per landmark and by the
    current time ``t_now`` - one compiled function serves every frame of a
    growing trajectory.
  * All edge math (relative poses, 3x3 covariance rotations, analytic
    inverses, Jacobian products) is batched over ``(P, L)`` - pure
    elementwise work, no per-edge Python (the reference rebuilds every pair from
    scratch each GN iteration of each frame in Python, its hot spot).
  * Assembly is one scatter-add of 3x3 blocks into a ``(T1, T1, 3, 3)``
    layout (XLA fuses duplicate-index adds), then a reshape to (3T1, 3T1).
  * Times never observed in any pair get identity diagonal blocks: their
    update is exactly zero, they decouple from the solve, and - because the
    padding blocks are identity - det(padded H) == det(reference's
    compacted H).
  * The reference solves an ill-conditioned system in float64 (it tolerates
    cond up to 1e15); accelerators are float32-first, so the solve is
    symmetrically Jacobi-preconditioned (which also scales out the 1e4 anchor) and
    followed by one iterative-refinement pass.
  * The GN loop is a ``lax.while_loop`` with the reference's
    ``||dx||^2 >= 0.01`` criterion plus an iteration cap.

CAPACITY.  This dense reference-exact path materializes every landmark's
all-pairs edge set (``~T1^2/2 * L`` premultiplied 3x3 blocks, so memory
grows as ``T1^2 * L * 9`` floats) and assembles a dense ``(3T1, 3T1)``
H; with ``guard="full"`` each GN iteration also runs a full SVD for the
reference's cond check (graph_based_slam.py:494-496).  That is the right
trade at demo scale (the whole 18-frame course is one compiled program;
its time on the GPU is in PERF.md) but walls off around a few thousand
poses.  Beyond that use ``slam/large.py`` (windowed edges, banded flat
assembly, Thomas/CR/CG solvers, ``exact_jacobians=True``), which scales
to 1M poses.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import jax
import jax.numpy as jnp
import numpy as np

from slamsim.core.angles import wrap_angle
from slamsim.core.precision import highest_matmul_precision
from slamsim.core.se2 import BASE_ANG
from slamsim.models.scan_sensor import ScanConfig


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Static graph-SLAM solver configuration.

    Defaults mirror the reference demo (graph_based_slam.py:604,630,
    900-921): 5% range noise, 2deg bearing/orientation sigma, GN threshold
    ``||dx||^2 < 0.01``, gauge anchor 1e4, det/cond guards 0.1 / 1e15.
    """

    max_times: int  # T1: capacity of the padded time axis
    num_landmarks: int
    scan: ScanConfig = ScanConfig(
        dist_gain=0.05, dir_sigma=math.radians(2.0),
        orient_sigma=math.radians(2.0))
    anchor: float = 1.0e4  # graph_based_slam.py:475 (TODO marked; kept)
    delta_sum_threshold: float = 0.01  # __DELTA_SUM_TH (:630)
    max_gn_iters: int = 50
    det_min: float = 0.1  # (:496)
    cond_max: float = 1.0e15  # (:496)
    #: "full" computes det + SVD condition number like the reference
    #: (fine to ~1k poses); "cheap" uses slogdet + a diagonal-ratio bound;
    #: "off" skips the guards (large-scale benchmarks).
    guard: str = "full"
    #: iterative-refinement passes after the preconditioned f32 solve.
    refine_iters: int = 1
    #: Reference quirk (graph_based_slam.py:419-427): the edge residual is
    #: built from OBSERVED orientations and is therefore linear in the
    #: poses (independent of estimated yaw), yet the reference linearizes
    #: with yaw-dependent Jacobians - at demo scale the 1e4 anchor hides
    #: the inconsistency; at hundreds of poses GN wanders in yaw.  False
    #: (default) reproduces the reference; True uses the exact Jacobians
    #: J = +/-I of the actual residual (the large-scale path's default).
    exact_jacobians: bool = False
    #: Levenberg-Marquardt compat option: solve (H + damping*diag(H)) dx
    #: = -b instead of plain Gauss-Newton.  0.0 (default) reproduces the
    #: reference exactly (graph_based_slam.py:497 solves undamped).  A
    #: small value (~1e-2) tames the yaw wander of the reference's
    #: inconsistent Jacobians (see ``exact_jacobians``) at trajectory
    #: lengths where the 1e4 anchor no longer dominates, making the
    #: reference formulation usable beyond demo scale.  Guards (det/cond)
    #: still evaluate the UNDAMPED H, as the reference does.  Must be
    #: >= 0: a negative value would SUBTRACT from the diagonal and
    #: silently worsen the conditioning of the solve.
    damping: float = 0.0
    #: f32 solvability gate, applied ON TOP of the reference's
    #: ``cond_max``: the reference evaluates its guards and inverts H in
    #: float64 (graph_based_slam.py:494-497), so it both DETECTS
    #: structurally singular frames (det 0 / cond 1e19 - degenerate
    #: co-visibility produces them on real courses) and solves accurately
    #: up to cond ~1e15.  An f32 LU of such a frame returns garbage (or
    #: NaN from an exact zero pivot) while the f32 slogdet/SVD round the
    #: singularity away (measured: a sign=0/-inf f64 slogdet reads
    #: det=3e17, cond=3.6e10 in f32).  Since f32 can neither certify nor
    #: solve past ~1e8, frames whose estimated cond exceeds this cap are
    #: rejected exactly like the reference rejects its f64-detected
    #: singular frames - strictly closer to reference behavior than
    #: applying an uncertifiable update.  Healthy demo frames sit at
    #: cond ~1e3-1e5 (live-reference parity tests unaffected).  Set to
    #: inf to disable (pure reference semantics; only safe with f64).
    cond_f32_cap: float = 1.0e8

    def __post_init__(self):
        if self.damping < 0.0:
            raise ValueError(
                f"GraphConfig.damping must be >= 0, got {self.damping}; "
                "negative damping subtracts from diag(H) and degrades "
                "conditioning")


class GraphObservations(typing.NamedTuple):
    """Padded landmark-sighting tensors; row t = scan at time t."""

    dist: jax.Array  # (T1, L)
    bearing: jax.Array  # (T1, L)
    orient: jax.Array  # (T1, L)
    valid: jax.Array  # (T1, L) bool


class GraphSolveResult(typing.NamedTuple):
    poses: jax.Array  # (T1, 3) updated estimates
    is_calc: jax.Array  # bool: last GN iteration passed the guards
    gn_iters: jax.Array  # int
    delta_sum: jax.Array  # final ||dx||^2
    det: jax.Array  # det(H) of the last iteration (slogdet-safe)
    cond: jax.Array  # cond(H) of the last iteration
    #: Per-GN-iteration diagnostics, padded to ``max_gn_iters`` with NaN
    #: past ``gn_iters``.  These reproduce the reference's per-loop
    #: "Loop(n)" printout data (graph_based_slam.py:709) which it emits
    #: for EVERY Gauss-Newton iteration, not just the last.
    trace_delta_sum: jax.Array  # (max_gn_iters,)
    trace_det: jax.Array  # (max_gn_iters,)
    trace_cond: jax.Array  # (max_gn_iters,)


def upper_pairs(t1: int):
    """Static (i, j) index arrays of all i<j time pairs (host-side)."""
    iu = np.triu_indices(t1, k=1)
    return jnp.asarray(iu[0]), jnp.asarray(iu[1])


def _inv3x3(m):
    """Analytic batched 3x3 inverse via the adjugate (no LAPACK call)."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 0, 2]
    d = m[..., 1, 0]
    e = m[..., 1, 1]
    f = m[..., 1, 2]
    g = m[..., 2, 0]
    h = m[..., 2, 1]
    i = m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack([
        jnp.stack([co_a, -(b * i - c * h), b * f - c * e], axis=-1),
        jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([co_c, -(a * h - b * g), a * e - b * d], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


def _measurement_cov_world(cfg: GraphConfig, dist, bearing, pose_yaw):
    """World-frame sighting covariance, batched.

    Composition of ``getLandMarkCovMatrixOnMeasurementSys`` and
    ``tfMeasurement2World`` (graph_based_slam.py:175-215), fused: rotate
    the diagonal measurement covariance by ang = bearing + yaw - BASE_ANG.
    """
    sc = cfg.scan
    v0 = jnp.square(dist * sc.dist_gain)
    v1 = jnp.square(dist * math.sin(sc.dir_sigma))
    v2 = jnp.full_like(dist, sc.dir_sigma ** 2 + sc.orient_sigma ** 2)
    ang = bearing + pose_yaw - BASE_ANG
    c, s = jnp.cos(ang), jnp.sin(ang)
    # R diag(v0,v1,.) R^T for the 2x2 part; theta row/col untouched.
    xx = c * c * v0 + s * s * v1
    xy = c * s * (v0 - v1)
    yy = s * s * v0 + c * c * v1
    z = jnp.zeros_like(xx)
    return jnp.stack([
        jnp.stack([xx, xy, z], axis=-1),
        jnp.stack([xy, yy, z], axis=-1),
        jnp.stack([z, z, v2], axis=-1),
    ], axis=-2)


@highest_matmul_precision
def build_edges(cfg: GraphConfig, poses, obs: GraphObservations, t_now,
                pair_i, pair_j):
    """Batched pose-pair constraint construction.

    Vectorized equivalent of ``TrajectoryEstimator.setPairObs``
    (graph_based_slam.py:362-439) over every (time-pair p, landmark l):

    Returns a dict of ``(P, L, ...)`` block tensors (masked by validity):
    ``h_bb, h_ba, h_ab, h_aa`` (3x3) and ``b_b, b_a`` (3,), plus the
    ``(P, L)`` mask.
    """
    t1 = poses.shape[0]
    # Gather per-pair observation fields -> (P, L).
    d_b, d_a = obs.dist[pair_i], obs.dist[pair_j]
    dir_b, dir_a = obs.bearing[pair_i], obs.bearing[pair_j]
    or_b, or_a = obs.orient[pair_i], obs.orient[pair_j]
    mask = (obs.valid[pair_i] & obs.valid[pair_j]
            & (pair_j <= t_now)[:, None])

    pose_b = poses[pair_i]  # (P, 3)
    pose_a = poses[pair_j]
    yaw_b = pose_b[:, 2:3]  # (P, 1) broadcasting over L
    yaw_a = pose_a[:, 2:3]

    # Relative pose from the current estimates (:398, 517-537).
    rel_rbt = pose_a - pose_b
    rel_rbt = rel_rbt.at[:, 2].set(wrap_angle(rel_rbt[:, 2]))

    # Relative pose implied by the two sightings (:400-403, 539-581).
    dirw_b = wrap_angle(jnp.pi + dir_b - or_b)
    dirw_a = wrap_angle(jnp.pi + dir_a - or_a)
    orw_b = wrap_angle(BASE_ANG - or_b)
    orw_a = wrap_angle(BASE_ANG - or_a)
    rel_obs_x = d_a * jnp.cos(dirw_a) - d_b * jnp.cos(dirw_b)
    rel_obs_y = d_a * jnp.sin(dirw_a) - d_b * jnp.sin(dirw_b)
    rel_obs_t = wrap_angle(orw_a - orw_b)

    # Pose error, yaw wrapped (:406-407).
    err = jnp.stack([
        rel_rbt[:, 0:1] - rel_obs_x,
        rel_rbt[:, 1:2] - rel_obs_y,
        wrap_angle(rel_rbt[:, 2:3] - rel_obs_t),
    ], axis=-1)  # (P, L, 3)

    # Information matrix Omega = inv(world cov aft + world cov bfr)
    # (:411-417).
    cov = (_measurement_cov_world(cfg, d_a, dir_a, yaw_a)
           + _measurement_cov_world(cfg, d_b, dir_b, yaw_b))
    omega = _inv3x3(cov)  # (P, L, 3, 3)

    # Analytic Jacobians (:419-427).
    th_b = wrap_angle(yaw_b + dir_b)
    th_a = wrap_angle(yaw_a + dir_a)
    zero = jnp.zeros_like(d_b)
    one = jnp.ones_like(d_b)

    def _jac(sign, d, th):
        return jnp.stack([
            jnp.stack([sign * one, zero, -sign * d * jnp.sin(th)], axis=-1),
            jnp.stack([zero, sign * one, sign * d * jnp.cos(th)], axis=-1),
            jnp.stack([zero, zero, sign * one], axis=-1),
        ], axis=-2)

    j_b = _jac(-1.0, d_b, th_b)  # (P, L, 3, 3)
    j_a = _jac(1.0, d_a, th_a)

    m = mask.astype(poses.dtype)[..., None, None]
    jt_om_b = jnp.einsum("plji,pljk->plik", j_b, omega)
    jt_om_a = jnp.einsum("plji,pljk->plik", j_a, omega)
    edges = {
        "h_bb": jnp.einsum("plij,pljk->plik", jt_om_b, j_b) * m,
        "h_ba": jnp.einsum("plij,pljk->plik", jt_om_b, j_a) * m,
        "h_ab": jnp.einsum("plij,pljk->plik", jt_om_a, j_b) * m,
        "h_aa": jnp.einsum("plij,pljk->plik", jt_om_a, j_a) * m,
        "b_b": jnp.einsum("plij,plj->pli", jt_om_b, err) * m[..., 0],
        "b_a": jnp.einsum("plij,plj->pli", jt_om_a, err) * m[..., 0],
        "mask": mask,
    }
    return edges


def kept_times(obs: GraphObservations, t_now):
    """Boolean (T1,) of times that participate in at least one pair.

    Mirrors the reference's ``KeepLandMarkTime`` bookkeeping
    (graph_based_slam.py:392-395): time t is kept iff it validly sights
    some landmark that is sighted at >= 2 (masked) times.
    """
    t1 = obs.valid.shape[0]
    in_time = obs.valid & (jnp.arange(t1) <= t_now)[:, None]
    cnt = jnp.sum(in_time, axis=0)  # (L,)
    return jnp.any(in_time & (cnt >= 2)[None, :], axis=1)


def assemble(cfg: GraphConfig, edges, kept, pair_i, pair_j, t1: int):
    """Scatter-add premultiplied blocks into (3T1, 3T1) H and (3T1,) b.

    Vectorized equivalent of the block scatter loop in ``updateEstPose``
    (graph_based_slam.py:471-492), including the 1e4*I gauge anchor on the
    first kept block (:474-475).  Times not kept receive identity diagonal
    blocks so H stays invertible while their update is exactly zero and
    det matches the reference's compacted matrix.
    """
    dtype = edges["h_bb"].dtype
    h4 = jnp.zeros((t1, t1, 3, 3), dtype)
    b3 = jnp.zeros((t1, 3), dtype)
    num_l = edges["h_bb"].shape[1]
    ib = jnp.repeat(pair_i, num_l)
    ia = jnp.repeat(pair_j, num_l)

    def fl(x):
        return x.reshape((-1,) + x.shape[2:])

    h4 = h4.at[ib, ib].add(fl(edges["h_bb"]))
    h4 = h4.at[ib, ia].add(fl(edges["h_ba"]))
    h4 = h4.at[ia, ib].add(fl(edges["h_ab"]))
    h4 = h4.at[ia, ia].add(fl(edges["h_aa"]))
    b3 = b3.at[ib].add(fl(edges["b_b"]))
    b3 = b3.at[ia].add(fl(edges["b_a"]))

    eye = jnp.eye(3, dtype=dtype)
    # Identity padding for non-kept times (see module docstring).
    diag_add = jnp.where(kept[:, None, None], 0.0, 1.0) * eye
    # Gauge anchor on the first kept time (the reference anchors block 0 of
    # its compacted, time-sorted matrix).
    first_kept = jnp.argmax(kept)
    anchor = jnp.zeros((t1,), dtype).at[first_kept].set(
        jnp.where(jnp.any(kept), cfg.anchor, 0.0))
    h4 = h4 + (diag_add + anchor[:, None, None] * eye) * jnp.eye(
        t1, dtype=dtype)[:, :, None, None]

    h = h4.transpose(0, 2, 1, 3).reshape(3 * t1, 3 * t1)
    return h, b3.reshape(-1)


@highest_matmul_precision
def preconditioned_solve(h, b, refine_iters: int = 1):
    """Symmetric Jacobi-preconditioned solve with iterative refinement.

    The reference does a float64 dense inverse (graph_based_slam.py:497)
    on a matrix whose condition number its own guard allows up to 1e15;
    float32 cannot solve that raw.  Scaling H symmetrically by
    1/sqrt(diag) normalizes the 1e4 anchor away and typically brings cond
    into comfortable f32 range; one refinement pass recovers most of the
    remaining residual.
    """
    d = jnp.diagonal(h)
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-30))
    hs = h * s[:, None] * s[None, :]
    bs = b * s

    # Factor once; refinement passes are two cheap triangular solves.
    lu, piv = jax.scipy.linalg.lu_factor(hs)

    def solve(rhs):
        return jax.scipy.linalg.lu_solve((lu, piv), rhs)

    y = solve(bs)
    for _ in range(refine_iters):
        r = bs - hs @ y
        y = y + solve(r)
    return y * s


def _guards(cfg: GraphConfig, h, kept):
    """det/cond solvability guards (graph_based_slam.py:494-496).

    ``h`` carries identity diagonal blocks on non-kept times (see
    :func:`assemble`): those leave det equal to the reference's compacted
    det, but inject singular values at exactly 1.0, which would REPLACE
    the true minimum when the compacted matrix's min-SV exceeds 1 and
    overstate cond.  For the cond evaluation the padding diagonal is
    therefore re-scaled to gamma = sqrt(min_kept_diag * max_kept_diag):
    for an SPD matrix min_sv <= min_diag <= gamma <= max_diag <= max_sv,
    so the padding SVs land strictly inside the kept range and the padded
    cond equals the compacted cond (verified frame-for-frame against the
    live reference in tests/test_reference_exec.py).
    """
    if cfg.guard == "off":
        t = jnp.asarray(1.0, h.dtype)
        return jnp.asarray(True), t, t
    sign, logdet = jnp.linalg.slogdet(h)
    det = sign * jnp.exp(jnp.clip(logdet, -80.0, 80.0))
    det_ok = (sign > 0) & (logdet > math.log(cfg.det_min))
    d = jnp.diagonal(h)
    kept3 = jnp.repeat(kept, 3)
    any_kept = jnp.any(kept3)
    d_min = jnp.min(jnp.where(kept3, d, jnp.inf))
    d_max = jnp.max(jnp.where(kept3, d, -jnp.inf))
    gamma = jnp.where(any_kept,
                      jnp.sqrt(jnp.maximum(d_min, 1e-30) *
                               jnp.maximum(d_max, 1e-30)), 1.0)
    if cfg.guard == "full":
        h_cond = h + jnp.diag(jnp.where(kept3, 0.0, gamma - 1.0))
        sv = jnp.linalg.svd(h_cond, compute_uv=False)
        cond = sv[0] / sv[-1]
    else:  # "cheap": diagonal ratio lower bound over the kept times
        cond = jnp.where(any_kept,
                         d_max / jnp.maximum(d_min, 1e-30), 1.0)
    cond_cap = min(cfg.cond_max, cfg.cond_f32_cap)
    return det_ok & (cond < cond_cap), det, cond


@highest_matmul_precision
def gn_iteration(cfg: GraphConfig, poses, obs: GraphObservations, t_now,
                 pair_i, pair_j):
    """One Gauss-Newton iteration: relinearize, assemble, guard, solve.

    Equivalent of one trip through ``estimateOpticalTrajectory``'s loop
    body (graph_based_slam.py:697-706) + ``updateEstPose``
    (graph_based_slam.py:452-514).

    Returns ``(poses', is_calc, delta_sum, det, cond)``.
    """
    t1 = poses.shape[0]
    kept = kept_times(obs, t_now)
    n_kept = jnp.sum(kept)
    edges = build_edges(cfg, poses, obs, t_now, pair_i, pair_j)
    h, b = assemble(cfg, edges, kept, pair_i, pair_j, t1)
    ok_guard, det, cond = _guards(cfg, h, kept)
    # Reference: no update at all unless >1 kept time (leng > 3, :469).
    ok = ok_guard & (n_kept > 1)

    h_solve = h
    if cfg.damping:
        # Marquardt scaling: h + damping*diag(h) == multiply the diagonal
        # by (1 + damping); leaves the identity padding rows harmless.
        h_solve = h + cfg.damping * jnp.diag(jnp.diagonal(h))
    delta = -preconditioned_solve(h_solve, b, cfg.refine_iters)
    # where(), not multiply: an exact zero pivot in the f32 LU of a
    # structurally singular frame yields NaN, and NaN * 0 = NaN would
    # leak through non-kept rows.
    delta = jnp.where(kept[:, None], delta.reshape(t1, 3), 0.0)
    # Never apply a non-finite update: the reference's f64 guards reject
    # such frames ("can Not calculate"), so a NaN/inf delta that slipped
    # past the f32 guard estimates is a guard failure, not an update.
    ok = ok & jnp.all(jnp.isfinite(delta))
    delta = jnp.where(ok, delta, 0.0)

    new_poses = poses + delta
    new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
    delta_sum = jnp.sum(delta * delta)
    return new_poses, ok, delta_sum, det, cond


@highest_matmul_precision
def graph_solve(cfg: GraphConfig, poses_init, obs: GraphObservations,
                t_now=None):
    """Full Gauss-Newton solve with re-linearization.

    Equivalent of ``Robot.estimateOpticalTrajectory``
    (graph_based_slam.py:685-715): iterate :func:`gn_iteration` until
    ``||dx||^2 < threshold`` (or the guards fail, which zeroes the delta
    and therefore terminates, as in the reference) with an iteration cap.

    Args:
        cfg: static solver config.
        poses_init: ``(T1, 3)`` initial pose estimates (odometry).
        obs: padded sighting tensors.
        t_now: last active time (defaults to T1-1, i.e. all rows active).

    Returns:
        :class:`GraphSolveResult`.
    """
    t1 = poses_init.shape[0]
    if t_now is None:
        t_now = t1 - 1
    t_now = jnp.asarray(t_now)
    pair_i, pair_j = upper_pairs(t1)

    def cond_fn(carry):
        _, _, delta_sum, iters, _, _, _ = carry
        return (delta_sum >= cfg.delta_sum_threshold) & (
            iters < cfg.max_gn_iters)

    def body_fn(carry):
        poses, _, _, iters, _, _, trace = carry
        poses, ok, delta_sum, det, cnd = gn_iteration(
            cfg, poses, obs, t_now, pair_i, pair_j)
        trace = tuple(buf.at[iters].set(v) for buf, v in
                      zip(trace, (delta_sum, det, cnd)))
        return poses, ok, delta_sum, iters + 1, det, cnd, trace

    nan_trace = tuple(
        jnp.full((cfg.max_gn_iters,), jnp.nan, poses_init.dtype)
        for _ in range(3))
    init = (poses_init, jnp.asarray(False),
            jnp.asarray(cfg.delta_sum_threshold, poses_init.dtype),
            jnp.asarray(0), jnp.asarray(0.0, poses_init.dtype),
            jnp.asarray(0.0, poses_init.dtype), nan_trace)
    poses, ok, delta_sum, iters, det, cnd, trace = jax.lax.while_loop(
        cond_fn, body_fn, init)
    return GraphSolveResult(poses=poses, is_calc=ok, gn_iters=iters,
                            delta_sum=delta_sum, det=det, cond=cnd,
                            trace_delta_sum=trace[0], trace_det=trace[1],
                            trace_cond=trace[2])
