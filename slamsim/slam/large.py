"""Large-scale graph SLAM: banded information matrix + CG, 10k+ poses.

The reference's graph estimator is dense: an all-pairs constraint set that
grows O(T^2) per landmark (graph_based_slam.py:698-703) and an O((3T)^3)
dense inverse (graph_based_slam.py:497).  That was written for 18 poses;
at the BASELINE target (10k poses / 1k landmarks, < 1 s on one chip,
BASELINE.json configs[4]) both are physically impossible.  This module is
the scaling redesign:

  * **Windowed pairing**: sightings of the same landmark pair up only
    within a time window ``W`` (consecutive-sighting chains + short loop
    closures), the standard sparsification of pose-graph SLAM.  The edge
    set becomes an explicit index-tensor :class:`EdgeList` built once,
    host-side, from the (static) visibility pattern.
  * **Block-banded storage**: with pairs bounded by ``W``, H is block-
    banded with ``D = W+1`` block diagonals.  The PRIMARY storage is
    the flat ``(D*9, T1)`` scalar-entry layout (upper band; symmetry
    gives the lower half) - the trajectory axis stays minor, so no
    array has a 3x3 minor tile to pad; the ``(D, T1, 3, 3)`` block view
    is derived for the solvers that still want it.
  * **Three solvers**: super-block tridiagonal Thomas
    (:mod:`slamsim.slam.tridiag`, dense matmul-shaped blocks - the
    production path), blocked 3x3 banded Cholesky
    (:mod:`slamsim.slam.cholesky`), and matrix-free block-Jacobi
    preconditioned CG (:func:`cg_solve`, one banded matvec = two batched
    ``(D, T1, 3, 3)`` einsums).
  * Same edge math as the dense path (:func:`slamsim.slam.graph
    .build_edges` parity with graph_based_slam.py:362-439), gathered per
    edge instead of materialized over all pairs.

The Gauss-Newton outer loop, gauge anchor, identity padding of
unconstrained times, and yaw wrapping all match the dense path.
"""

from __future__ import annotations

import typing

import jax
import jax.numpy as jnp
import numpy as np

from slamsim.core.angles import wrap_angle
from slamsim.core.precision import highest_matmul_precision
from slamsim.core.se2 import BASE_ANG
from slamsim.slam.graph import (GraphConfig, GraphObservations,
                                _inv3x3, _measurement_cov_world)


class EdgeList(typing.NamedTuple):
    """Explicit constraint index tensors; all fields ``(E,)``.

    ``t_b < t_a`` (before/after times), ``lm`` the landmark index, and
    ``valid`` a mask for padding slots.
    """

    t_b: jax.Array
    t_a: jax.Array
    lm: jax.Array
    valid: jax.Array


def window_pairs(valid: np.ndarray, window: int,
                 max_pairs_per_lm: int | None = None) -> EdgeList:
    """Host-side edge-list construction from a visibility matrix.

    For each landmark, every pair of sighting times ``(t_b, t_a)`` with
    ``t_a - t_b <= window`` becomes a constraint (the reference pairs ALL
    combinations - window=inf recovers that).

    Args:
        valid: ``(T1, L)`` boolean visibility (host numpy).
        window: max time separation of a pair (in steps).

    Returns:
        :class:`EdgeList` of device arrays.
    """
    t1, num_l = valid.shape
    # Vectorized construction: list all sightings sorted by (landmark,
    # time), then for each lag k pair sighting i with sighting i+k when
    # both belong to the same landmark and are within the window.  At 10k
    # poses / 1k landmarks this takes ~max-sightings passes over the
    # sighting list instead of a million-iteration Python loop.
    tt, ll = np.nonzero(valid)  # times, landmarks of all sightings
    order = np.lexsort((tt, ll))
    tt, ll = tt[order], ll[order]
    s = len(tt)
    counts = np.bincount(ll, minlength=num_l)
    k_max = int(counts.max()) if s else 0

    t_bs, t_as, lms = [], [], []
    for k in range(1, k_max + 1):
        same_lm = ll[:-k] == ll[k:] if k < s else np.zeros(0, bool)
        in_win = (tt[k:] - tt[:-k]) <= window if k < s else same_lm
        sel = same_lm & in_win
        t_bs.append(tt[:-k][sel])
        t_as.append(tt[k:][sel])
        lms.append(ll[:-k][sel])
    t_b = np.concatenate(t_bs) if t_bs else np.zeros(0, np.int64)
    t_a = np.concatenate(t_as) if t_as else np.zeros(0, np.int64)
    lm = np.concatenate(lms) if lms else np.zeros(0, np.int64)

    if max_pairs_per_lm is not None:
        # Cap pairs per landmark (keep the shortest lags first, matching
        # the spirit of the reference's insertion order).
        order = np.lexsort((t_a - t_b, lm))
        t_b, t_a, lm = t_b[order], t_a[order], lm[order]
        rank = np.zeros(len(lm), np.int64)
        if len(lm):
            # position within each landmark group
            first = np.r_[True, lm[1:] != lm[:-1]]
            idx = np.arange(len(lm))
            start = np.maximum.accumulate(np.where(first, idx, 0))
            rank = idx - start
        keep = rank < max_pairs_per_lm
        t_b, t_a, lm = t_b[keep], t_a[keep], lm[keep]

    e = len(t_b)
    return EdgeList(
        t_b=jnp.asarray(t_b.astype(np.int32)),
        t_a=jnp.asarray(t_a.astype(np.int32)),
        lm=jnp.asarray(lm.astype(np.int32)),
        valid=jnp.ones((e,), bool))


def count_window_pairs(valid: np.ndarray, window: int) -> int:
    """Exact edge count of :func:`window_pairs` (host; for sizing the
    static ``max_edges`` of :func:`window_pairs_device`)."""
    total = 0
    for d in range(1, min(window, valid.shape[0] - 1) + 1):
        total += int(np.sum(valid[:-d] & valid[d:]))
    return total


def window_pairs_device(valid, window: int, max_edges: int):
    """Device-side, jittable :func:`window_pairs` (same edge SET).

    The host variant builds the edge list with numpy from a concrete
    visibility matrix; this one runs under jit so the full pipeline
    (scene -> edges -> banded solve) stays on-device with no transfer.
    Shapes are static: candidates are compacted into ``max_edges`` slots
    by a per-lag cumsum scatter (lag loop is unrolled - ``window`` is
    static).  Edge ORDER differs from the host variant (grouped by time
    lag, not by landmark); assembly is order-invariant scatter-add.

    ``max_pairs_per_lm`` is not supported here (it needs a per-landmark
    rank, host-friendly but a poor fit for one-pass compaction); size
    with :func:`count_window_pairs` instead.

    Args:
        valid: ``(T1, L)`` boolean visibility (device array).
        window: max time separation of a pair (static).
        max_edges: static output capacity.  Edges beyond it are DROPPED
            silently - check the returned count.

    Returns:
        ``(EdgeList, n_edges)`` - fixed-shape ``(max_edges,)`` tensors
        with a validity mask, plus the true (traced) edge count; if
        ``n_edges > max_edges`` the list is truncated.
    """
    t1, num_l = valid.shape
    out_tb = jnp.zeros((max_edges,), jnp.int32)
    out_ta = jnp.zeros((max_edges,), jnp.int32)
    out_lm = jnp.zeros((max_edges,), jnp.int32)
    out_valid = jnp.zeros((max_edges,), bool)
    offset = jnp.asarray(0, jnp.int32)
    tt = jnp.arange(t1, dtype=jnp.int32)[:, None]
    lml = jnp.broadcast_to(jnp.arange(num_l, dtype=jnp.int32)[None, :],
                           (t1, num_l))
    for d in range(1, min(window, t1 - 1) + 1):
        m = (valid[:-d] & valid[d:]).reshape(-1)
        pos = jnp.cumsum(m.astype(jnp.int32)) - 1
        idx = jnp.where(m, offset + pos, max_edges)  # OOB slot -> dropped
        tb = jnp.broadcast_to(tt[:t1 - d], (t1 - d, num_l)).reshape(-1)
        lm = lml[:t1 - d].reshape(-1)
        out_tb = out_tb.at[idx].set(tb, mode="drop")
        out_ta = out_ta.at[idx].set(tb + d, mode="drop")
        out_lm = out_lm.at[idx].set(lm, mode="drop")
        out_valid = out_valid.at[idx].set(True, mode="drop")
        offset = offset + jnp.sum(m.astype(jnp.int32))
    return EdgeList(t_b=out_tb, t_a=out_ta, lm=out_lm,
                    valid=out_valid), offset


@highest_matmul_precision
def build_edge_blocks(cfg: GraphConfig, poses, obs: GraphObservations,
                      edges: EdgeList, omega_poses=None):
    """Per-edge premultiplied blocks, gathered by index tensors.

    Identical math to the dense path's ``build_edges`` (parity:
    graph_based_slam.py:362-439) but batched over an explicit ``(E,)``
    edge list instead of a dense (pairs x landmarks) grid.

    Args:
        omega_poses: poses used to rotate the measurement covariances
            into the world frame (defaults to ``poses``).  Passing the
            initial guess FREEZES the information matrices across GN
            iterations: the reference recomputes them from the current
            estimates, which feeds the estimate back into its own
            weights and - along the gauge-soft mode - can walk the
            solution away at scale; frozen Omega is the standard
            "information comes from measurements" choice and makes the
            exact-Jacobian problem strictly linear.

    Returns dict of ``(E, ...)`` tensors: h_bb, h_ba, h_aa, b_b, b_a.
    (h_ab = h_ba^T by construction; the banded assembly exploits that.)
    """
    if omega_poses is None:
        omega_poses = poses
    tb, ta, lm = edges.t_b, edges.t_a, edges.lm
    d_b = obs.dist[tb, lm]
    d_a = obs.dist[ta, lm]
    dir_b = obs.bearing[tb, lm]
    dir_a = obs.bearing[ta, lm]
    or_b = obs.orient[tb, lm]
    or_a = obs.orient[ta, lm]
    mask = (obs.valid[tb, lm] & obs.valid[ta, lm] & edges.valid)

    pose_b = poses[tb]
    pose_a = poses[ta]
    yaw_b = pose_b[:, 2]
    yaw_a = pose_a[:, 2]

    rel = pose_a - pose_b
    dwb = wrap_angle(jnp.pi + dir_b - or_b)
    dwa = wrap_angle(jnp.pi + dir_a - or_a)
    owb = wrap_angle(BASE_ANG - or_b)
    owa = wrap_angle(BASE_ANG - or_a)
    err = jnp.stack([
        rel[:, 0] - (d_a * jnp.cos(dwa) - d_b * jnp.cos(dwb)),
        rel[:, 1] - (d_a * jnp.sin(dwa) - d_b * jnp.sin(dwb)),
        wrap_angle(wrap_angle(rel[:, 2]) - wrap_angle(owa - owb)),
    ], axis=-1)  # (E, 3)

    om_yaw_b = omega_poses[tb][:, 2]
    om_yaw_a = omega_poses[ta][:, 2]
    cov = (_measurement_cov_world(cfg, d_a, dir_a, om_yaw_a)
           + _measurement_cov_world(cfg, d_b, dir_b, om_yaw_b))
    omega = _inv3x3(cov)

    m = mask.astype(poses.dtype)[:, None, None]
    if cfg.exact_jacobians:
        # The residual err = (pose_a - pose_b) - rel_obs(observations) is
        # exactly linear in the poses: J_a = I, J_b = -I.  The blocks
        # collapse to +/-Omega and the GN step is an exact least-squares
        # solve (see GraphConfig.exact_jacobians).
        om = omega * m
        om_err = jnp.einsum("eij,ej->ei", om, err)
        return {
            "h_bb": om,
            "h_ba": -om,
            "h_aa": om,
            "b_b": -om_err,
            "b_a": om_err,
            "mask": mask,
        }

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

    j_b = _jac(-1.0, d_b, th_b)
    j_a = _jac(1.0, d_a, th_a)

    jt_om_b = jnp.einsum("eji,ejk->eik", j_b, omega)
    jt_om_a = jnp.einsum("eji,ejk->eik", j_a, omega)
    return {
        "h_bb": jnp.einsum("eij,ejk->eik", jt_om_b, j_b) * m,
        "h_ba": jnp.einsum("eij,ejk->eik", jt_om_b, j_a) * m,
        "h_aa": jnp.einsum("eij,ejk->eik", jt_om_a, j_a) * m,
        "b_b": jnp.einsum("eij,ej->ei", jt_om_b, err) * m[..., 0],
        "b_a": jnp.einsum("eij,ej->ei", jt_om_a, err) * m[..., 0],
        "mask": mask,
    }


@highest_matmul_precision
def exact_edge_terms(cfg: GraphConfig, obs: GraphObservations,
                     edges: EdgeList, omega_poses):
    """Constant per-edge terms of the exact-linear formulation.

    With ``exact_jacobians=True`` and frozen Omega the residual is
    ``err = (pose_a - pose_b) - rel_obs`` with ``rel_obs`` a pure
    function of the observations, and the information ``om`` is fixed at
    ``omega_poses``: H never changes across GN iterations — only the
    rhs does.  This computes the two constants once (same expressions
    as :func:`build_edge_blocks`, so :func:`exact_rhs_flat` rebuilds the
    rhs bit-identically to the full assembly).

    Returns ``(om (E, 3, 3) mask-premultiplied, rel_obs (E, 3),
    mask (E,))``.
    """
    tb, ta, lm = edges.t_b, edges.t_a, edges.lm
    d_b = obs.dist[tb, lm]
    d_a = obs.dist[ta, lm]
    dir_b = obs.bearing[tb, lm]
    dir_a = obs.bearing[ta, lm]
    or_b = obs.orient[tb, lm]
    or_a = obs.orient[ta, lm]
    mask = (obs.valid[tb, lm] & obs.valid[ta, lm] & edges.valid)

    dwb = wrap_angle(jnp.pi + dir_b - or_b)
    dwa = wrap_angle(jnp.pi + dir_a - or_a)
    owb = wrap_angle(BASE_ANG - or_b)
    owa = wrap_angle(BASE_ANG - or_a)
    rel_obs = jnp.stack([
        d_a * jnp.cos(dwa) - d_b * jnp.cos(dwb),
        d_a * jnp.sin(dwa) - d_b * jnp.sin(dwb),
        wrap_angle(owa - owb),
    ], axis=-1)

    om_yaw_b = omega_poses[tb][:, 2]
    om_yaw_a = omega_poses[ta][:, 2]
    cov = (_measurement_cov_world(cfg, d_a, dir_a, om_yaw_a)
           + _measurement_cov_world(cfg, d_b, dir_b, om_yaw_b))
    om = _inv3x3(cov) * mask.astype(omega_poses.dtype)[:, None, None]
    return om, rel_obs, mask


@highest_matmul_precision
def exact_edge_omega(cfg: GraphConfig, obs: GraphObservations,
                     edges: EdgeList, omega_poses, mask):
    """Recompute ONLY the per-edge information blocks ``om`` from new
    linearization poses (the Omega half of :func:`exact_edge_terms`;
    ``rel_obs`` and ``mask`` are pose-independent and stay fixed).

    The reference recomputes these from the current estimates every GN
    iteration (graph_based_slam.py:411-417); the refactor-every-k loop
    (:func:`_graph_solve_banded_relin_reuse`) calls this at each refresh.
    """
    tb, ta, lm = edges.t_b, edges.t_a, edges.lm
    d_b = obs.dist[tb, lm]
    d_a = obs.dist[ta, lm]
    dir_b = obs.bearing[tb, lm]
    dir_a = obs.bearing[ta, lm]
    om_yaw_b = omega_poses[tb][:, 2]
    om_yaw_a = omega_poses[ta][:, 2]
    cov = (_measurement_cov_world(cfg, d_a, dir_a, om_yaw_a)
           + _measurement_cov_world(cfg, d_b, dir_b, om_yaw_b))
    return _inv3x3(cov) * mask.astype(omega_poses.dtype)[:, None, None]


@highest_matmul_precision
def exact_rhs_flat(poses, om, rel_obs, edges: EdgeList, t1: int):
    """Rebuild ONLY the rhs ``b_flat (3, T1)`` from the current poses.

    The per-GN-iteration work of the factor-reuse path: gather the two
    pose endpoints per edge, form the linear residual, weight by the
    frozen ``om``, scatter.  Bit-identical to the b half of
    :func:`build_edge_blocks` + :func:`assemble_banded_flat` given the
    same ``(om, rel_obs)`` (see :func:`exact_edge_terms`).
    """
    tb, ta = edges.t_b, edges.t_a
    rel = poses[ta] - poses[tb]
    err = jnp.stack([
        rel[:, 0] - rel_obs[:, 0],
        rel[:, 1] - rel_obs[:, 1],
        wrap_angle(wrap_angle(rel[:, 2]) - rel_obs[:, 2]),
    ], axis=-1)
    om_err = jnp.einsum("eij,ej->ei", om, err)
    b_flat = jnp.zeros((3, t1), poses.dtype)
    b_flat = b_flat.at[:, tb].add(-om_err.T)
    b_flat = b_flat.at[:, ta].add(om_err.T)
    return b_flat


def assemble_banded_flat(cfg: GraphConfig, blocks, edges: EdgeList,
                         t1: int, band: int):
    """Scatter-add edge blocks into FLAT banded storage.

    ``h_flat[d*9 + 3a + b, i]`` holds scalar ``H[i, i+d][a, b]`` (upper
    band, d in [0, band]); ``b_flat[a, i]`` the rhs.  The flat layout
    keeps the trajectory axis minor (see the comment below) and is the
    native input of the
    flat tridiagonal solver (:func:`slamsim.slam.tridiag.\
banded_solve_tridiag_flat`).

    Returns ``(h_flat ((band+1)*9, T1), b_flat (3, T1), kept (T1,))``.
    """
    dtype = blocks["h_bb"].dtype
    # Scatter into a FLAT ((band+1)*9, t1) layout - t1 on the minor dim.
    # Scattering into (band+1, t1, 3, 3) directly makes XLA materialize
    # the array with the 3x3 dims minor, which a tiled layout pads many
    # times over.  Entry-row scatters keep the natural layout; cost is 27
    # small scatters of E rows each.
    h_flat = jnp.zeros(((band + 1) * 9, t1), dtype)
    b_flat = jnp.zeros((3, t1), dtype)
    d = edges.t_a - edges.t_b
    for k in range(9):
        r, c = divmod(k, 3)
        h_flat = h_flat.at[k, edges.t_b].add(blocks["h_bb"][:, r, c])
        h_flat = h_flat.at[k, edges.t_a].add(blocks["h_aa"][:, r, c])
        h_flat = h_flat.at[d * 9 + k, edges.t_b].add(
            blocks["h_ba"][:, r, c])
    b_flat = b_flat.at[:, edges.t_b].add(blocks["b_b"].T)
    b_flat = b_flat.at[:, edges.t_a].add(blocks["b_a"].T)

    m = blocks["mask"]
    kept = (jnp.zeros((t1,), jnp.int32)
            .at[edges.t_b].add(m.astype(jnp.int32))
            .at[edges.t_a].add(m.astype(jnp.int32))) > 0

    # Identity padding for unconstrained times (delta stays exactly 0)
    # + gauge anchor on the first kept block (graph_based_slam.py:474-475).
    first_kept = jnp.argmax(kept)
    anchor = jnp.where(jnp.any(kept), cfg.anchor, 0.0)
    for k in (0, 4, 8):
        h_flat = h_flat.at[k].add(jnp.where(kept, 0.0, 1.0))
        h_flat = h_flat.at[k, first_kept].add(anchor)
    return h_flat, b_flat, kept


def assemble_banded(cfg: GraphConfig, blocks, edges: EdgeList, t1: int,
                    band: int):
    """Scatter-add edge blocks into block-banded storage.

    ``h_band[d, i]`` holds block ``H[i, i+d]`` (upper band, d in [0, band]).

    Returns ``(h_band (band+1, T1, 3, 3), b (T1, 3), kept (T1,))``.
    """
    h_flat, b_flat, kept = assemble_banded_flat(cfg, blocks, edges, t1,
                                                band)
    h_band = jnp.transpose(h_flat.reshape(band + 1, 9, t1),
                           (0, 2, 1)).reshape(band + 1, t1, 3, 3)
    return h_band, b_flat.T, kept


def odometry_rhs_flat(b_flat, poses, rel_odom, odom_info):
    """The rhs half of :func:`add_odometry_chain_flat` (the chain's H
    contribution is pose-independent; the factor-reuse GN loop rebuilds
    only this per iteration)."""
    info = jnp.asarray(odom_info, poses.dtype)
    rel = poses[1:] - poses[:-1]
    err = rel - rel_odom
    err = err.at[:, 2].set(wrap_angle(err[:, 2]))
    w_err = (err * info).T  # (3, T1-1)
    b_flat = b_flat.at[:, :-1].add(-w_err)
    b_flat = b_flat.at[:, 1:].add(w_err)
    return b_flat


def add_odometry_chain_flat(h_flat, b_flat, poses, rel_odom, odom_info):
    """Flat-layout twin of :func:`add_odometry_chain` (diagonal-
    information motion chain; pure row slice-adds, no scatters)."""
    info = jnp.asarray(odom_info, poses.dtype)
    for r in range(3):
        k = 4 * r  # diagonal entry (r, r)
        h_flat = h_flat.at[k, :-1].add(info[r])
        h_flat = h_flat.at[k, 1:].add(info[r])
        h_flat = h_flat.at[9 + k, :-1].add(-info[r])
    b_flat = odometry_rhs_flat(b_flat, poses, rel_odom, odom_info)
    return h_flat, b_flat


def add_odometry_chain(h_band, bvec, poses, rel_odom, odom_info):
    """Add consecutive-pose odometry constraints to the banded system.

    The reference's graph contains ONLY landmark-pair constraints
    (graph_based_slam.py:698-703); at its 18-pose scale the 1e4 anchor
    plus dense co-visibility keep the graph rigid.  At 10k poses the
    landmark graph can have weakly-anchored components whose 3-dim gauge
    modes drift; the standard pose-graph fix - and what any real SLAM
    frontend provides - is a motion-model edge between consecutive poses.

    Residual: ``(pose[t+1] - pose[t]) - rel_odom[t]`` (yaw wrapped),
    linear in the poses, with diagonal information ``odom_info``.

    Args:
        rel_odom: ``(T1-1, 3)`` measured odometry deltas.
        odom_info: ``(3,)`` information diagonal (1/sigma^2 per axis).

    Returns:
        Updated ``(h_band, bvec)``.
    """
    t1 = poses.shape[0]
    info = jnp.asarray(odom_info, poses.dtype)
    omega = jnp.diag(info)
    rel = poses[1:] - poses[:-1]
    err = rel - rel_odom
    err = err.at[:, 2].set(wrap_angle(err[:, 2]))
    w_err = err * info  # (T1-1, 3) = Omega @ err rows

    idx = jnp.arange(t1 - 1)
    # J_b = -I (pose t), J_a = +I (pose t+1): blocks are +/-Omega.
    h_band = h_band.at[0, idx].add(omega)
    h_band = h_band.at[0, idx + 1].add(omega)
    h_band = h_band.at[1, idx].add(-omega)
    bvec = bvec.at[idx].add(-w_err)
    bvec = bvec.at[idx + 1].add(w_err)
    return h_band, bvec


def make_banded_matvec(h_band):
    """Build a fast ``x -> H x`` closure for block-banded upper storage.

    Precomputes (once per H) the masked upper band and the shifted,
    transposed lower band so each matvec is TWO batched einsums over
    ``(D, T1, 3, 3)`` tensors plus two gathers of x - one big fused
    elementwise pass instead of 2*D small ops (which made the CG loop op-count-bound).
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    offs = jnp.arange(d1)[:, None]  # (D, 1)
    rows = jnp.arange(t1)[None, :]  # (1, T1)

    # Upper: y[i] += sum_d H[d, i] @ x[i + d]   (valid while i + d < T1)
    idx_u = rows + offs  # (D, T1)
    valid_u = (idx_u < t1)[..., None]
    idx_u = jnp.clip(idx_u, 0, t1 - 1)
    h_up = h_band * valid_u[..., None]

    # Lower: y[j] += sum_{d>=1} H[d, j - d]^T @ x[j - d]
    idx_l = rows - offs  # (D, T1)
    valid_l = ((idx_l >= 0) & (offs >= 1))[..., None]
    idx_l = jnp.clip(idx_l, 0, t1 - 1)
    h_low = jnp.swapaxes(
        h_band[jnp.arange(d1)[:, None], idx_l], -1, -2) * valid_l[..., None]

    def matvec(x):
        xu = x[idx_u] * valid_u
        xl = x[idx_l] * valid_l
        return (jnp.einsum("dtij,dtj->ti", h_up, xu)
                + jnp.einsum("dtij,dtj->ti", h_low, xl))

    return matvec


@highest_matmul_precision
def banded_matvec(h_band, x):
    """y = H x with block-banded upper storage + symmetry (one-shot API;
    inside iterative solvers use :func:`make_banded_matvec` once)."""
    return make_banded_matvec(h_band)(x)


@highest_matmul_precision
def cg_solve(h_band, b, max_iters: int = 200, tol: float = 1e-8):
    """Block-Jacobi-preconditioned conjugate gradients on banded H.

    Matrix-free: only :func:`banded_matvec` touches H.  The iteration
    itself is the shared :func:`slamsim.core.pcg.pcg` driver.  Returns
    the solution of ``H x = b``.
    """
    from slamsim.core.pcg import pcg

    minv = _inv3x3(h_band[0])  # (T1, 3, 3) block-Jacobi preconditioner
    matvec = make_banded_matvec(h_band)

    def precond(r):
        return jnp.einsum("tij,tj->ti", minv, r)

    def dot(a, c):
        return jnp.sum(a * c)

    return pcg(matvec, precond, dot, b, max_iters, tol)


def make_banded_matvec_flat(h_flat, band: int):
    """Flat-layout twin of :func:`make_banded_matvec`.

    ``x -> H x`` with BOTH operands in flat phase-major storage
    (``h_flat[(d*9 + 3a + b), t] = H[t, t+d][a, b]``, ``x`` as
    ``(3, T1)`` rows): each of the ``9 * (band+1)`` scalar band entries
    contributes one elementwise multiply against a STATICALLY SHIFTED
    copy of an ``x`` row (upper term) and one against an unshifted row
    whose product is shifted back (lower/transpose term).  No gathers,
    no ``(.., 3, 3)``-trailing intermediates - the band-layout matvec's
    ``x[idx_u]`` gathers and ``(D, T1, 3, 3)`` masks are what cap the CG
    path at ~150k poses.  Shifts are static pads/slices, so the whole
    matvec compiles to ~2 * 9 * D fused elementwise passes over ``T1``.
    """
    d1 = band + 1
    t1 = h_flat.shape[1]
    # Row (d, a, b) as a (1, T1) slice; keep 2-D so every op stays on
    # clean (sublane, lane) layouts.
    h = h_flat.reshape(d1, 9, t1)

    def matvec(x):
        # x: (3, T1) -> y: (3, T1)
        # Accumulate the lower-term rows first: z_b^{(d)} = sum_a
        # H[t, t+d][a, b] x[a, t], then y[b, t+d] += z_b^{(d)}[t].
        y = [jnp.zeros((t1,), x.dtype) for _ in range(3)]
        for d in range(d1):
            if d == 0:
                xs = x
            else:
                xs = jnp.pad(x[:, d:], ((0, 0), (0, d)))
            for a in range(3):
                acc = None
                for b in range(3):
                    term = h[d, 3 * a + b] * xs[b]
                    acc = term if acc is None else acc + term
                y[a] = y[a] + acc  # upper: y[a, t] += H[t,t+d][a,:] x[:, t+d]
            if d:
                for b in range(3):
                    z = None
                    for a in range(3):
                        term = h[d, 3 * a + b] * x[a]
                        z = term if z is None else z + term
                    # lower: y[b, t+d] += z[t]  (shift right by d)
                    y[b] = y[b] + jnp.pad(z[:-d], (d, 0))
        return jnp.stack(y)

    return matvec


def _inv3x3_flat(h9):
    """Closed-form inverse of per-lane 3x3 blocks stored as 9 scalar
    rows ``h9[(3a + b), t]``; returns the same layout.  (Reshaping to
    ``(T1, 3, 3)`` for :func:`_inv3x3` would materialize a tile-padded
    small-trailing-dim tensor at trajectory scale.)"""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [h9[k] for k in range(9)]
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    # Same adjugate/det expression as graph.py::_inv3x3 (no guard): the
    # assembled diagonal blocks are never singular (anchor + identity
    # padding), and twin behavior with the band-layout preconditioner
    # matters more than defensiveness here.
    return jnp.stack([c00, c01, c02, c10, c11, c12, c20, c21, c22]) / det


@highest_matmul_precision
def cg_solve_flat(h_flat, b_flat, band: int, max_iters: int = 200,
                  tol: float = 1e-8):
    """Flat-layout twin of :func:`cg_solve` (same PCG driver, same
    block-Jacobi preconditioner) operating end-to-end on
    ``((band+1)*9, T1)`` / ``(3, T1)`` storage so the matrix-free path
    scales to 1M poses like the tridiag/CR production solvers.

    Returns ``((T1, 3) solution, iterations)``.
    """
    from slamsim.core.pcg import pcg

    minv9 = _inv3x3_flat(h_flat[0:9])
    matvec = make_banded_matvec_flat(h_flat, band)

    def precond(r):
        return jnp.stack([
            minv9[3 * a + 0] * r[0] + minv9[3 * a + 1] * r[1]
            + minv9[3 * a + 2] * r[2] for a in range(3)])

    def dot(a, c):
        return jnp.sum(a * c)

    x, iters = pcg(matvec, precond, dot, b_flat, max_iters, tol)
    return x.T, iters


def make_large_scene(cfg: GraphConfig, key, n_poses: int,
                     n_landmarks: int, radius: float = 200.0,
                     odom_noise: float = 0.02,
                     scan_chunk: int | None = None):
    """Synthetic large-loop scenario for the 10k-pose benchmark.

    Ground truth is a circular course (the reference demo's geometry
    scaled up, graph_based_slam.py:903-907) with landmarks scattered in an
    annulus around the path; observations come from one batched
    :func:`~slamsim.models.scan_sensor.scan` call over all poses; the
    odometry initial guess is truth + a small random-walk drift (the
    structure GN must correct).

    Args:
        scan_chunk: process the scan in pose chunks of this size via
            ``lax.map`` (the scan's (chunk, L, 2) intermediates otherwise
            exhaust HBM around T1 x L ~ 1e8; the (T1, L) OUTPUT tensors
            still materialize).  Must divide ``n_poses``.

    Returns ``(poses_true, poses_odom, obs)`` with ``(T1, ...)`` /
    ``(T1, L)`` shapes (T1 = n_poses).
    """
    from slamsim.models.scan_sensor import scan as sensor_scan

    k_lm, k_scan, k_odo = jax.random.split(key, 3)
    t = jnp.arange(n_poses, dtype=jnp.float32)
    phi = t * (2.0 * jnp.pi / n_poses)
    poses_true = jnp.stack([
        radius * jnp.cos(phi),
        radius * jnp.sin(phi),
        wrap_angle(phi + BASE_ANG),
    ], axis=-1)

    r_lm = radius + jax.random.uniform(k_lm, (n_landmarks,),
                                       minval=-10.0, maxval=10.0)
    a_lm = jax.random.permutation(
        k_lm, jnp.arange(n_landmarks, dtype=jnp.float32)) * (
            2.0 * jnp.pi / n_landmarks)
    landmarks = jnp.stack([r_lm * jnp.cos(a_lm), r_lm * jnp.sin(a_lm)],
                          axis=-1)

    if scan_chunk is None:
        noisy, _ = sensor_scan(cfg.scan, k_scan, poses_true, landmarks)
    else:
        if n_poses % scan_chunk:
            raise ValueError(f"scan_chunk {scan_chunk} must divide "
                             f"n_poses {n_poses}")
        n_chunks = n_poses // scan_chunk
        keys = jax.random.split(k_scan, n_chunks)
        poses_c = poses_true.reshape(n_chunks, scan_chunk, 3)

        def one_chunk(args):
            k, p = args
            n, _ = sensor_scan(cfg.scan, k, p, landmarks)
            return n

        chunks = jax.lax.map(one_chunk, (keys, poses_c))
        noisy = jax.tree.map(
            lambda x: x.reshape((n_poses,) + x.shape[2:]), chunks)

    drift = jnp.cumsum(
        jax.random.normal(k_odo, (n_poses, 3)) * odom_noise, axis=0)
    poses_odom = poses_true + drift
    poses_odom = poses_odom.at[:, 2].set(wrap_angle(poses_odom[:, 2]))
    return poses_true, poses_odom, GraphObservations(*noisy)


class BandedSolveResult(typing.NamedTuple):
    poses: jax.Array
    gn_iters: jax.Array
    delta_sum: jax.Array
    cg_iters_last: jax.Array


@highest_matmul_precision
def graph_solve_banded(cfg: GraphConfig, poses_init,
                       obs: GraphObservations, edges: EdgeList, band: int,
                       cg_iters: int = 200, cg_tol: float = 1e-8,
                       rel_odom=None, odom_info=(100.0, 100.0, 400.0),
                       solver: str = "cg",
                       relinearize_omega: bool = False,
                       delta_tol: float | None = None,
                       damping: float = 0.0,
                       super_size: int | None = None,
                       stall_ratio: float | None = None,
                       reuse_factorization: bool | None = None,
                       refactor_every: int | None = None,
                       n_parts: int | None = None):
    """Gauss-Newton with banded assembly + selectable inner solver.

    The large-scale twin of :func:`slamsim.slam.graph.graph_solve`: same
    relinearize -> assemble -> solve -> apply loop and the same
    ``||dx||^2 < threshold`` criterion; guards are replaced by the CG
    residual check (dense det/cond are meaningless at this scale).

    Args:
        rel_odom: optional ``(T1-1, 3)`` odometry deltas; when given, a
            consecutive-pose motion chain with information ``odom_info``
            is added (see :func:`add_odometry_chain`) - strongly
            recommended at scale.
        solver: ``"cg"`` (block-Jacobi PCG, matrix-free), ``"cholesky"``
            (exact blocked banded Cholesky, :mod:`slamsim.slam.cholesky`),
            ``"tridiag"`` (super-block tridiagonal Thomas,
            :mod:`slamsim.slam.tridiag` - dense blocks, O(N) sequential
            depth), or ``"cr"`` (super-block cyclic reduction,
            :mod:`slamsim.slam.cyclic` - O(log N) depth, the
            latency-optimal production solver for long trajectories).
        relinearize_omega: recompute the measurement information from the
            CURRENT estimates each GN iteration (the reference's
            behavior, graph_based_slam.py:411-417).  Default False:
            freeze Omega at the initial guess (see
            :func:`build_edge_blocks`) - at hundreds of poses the
            reweighting feedback can walk the solution along the
            gauge-soft mode.  True recomputes the blocks every
            iteration and so disables factor reuse.
        delta_tol: GN stop threshold on ||dx||^2.  Defaults to the
            reference's absolute ``cfg.delta_sum_threshold`` (0.01) -
            which at 10k poses is below f32 solve noise, so GN runs to
            max_gn_iters; pass e.g. ``1e-6 * T1`` (per-pose tolerance)
            for long trajectories.
        damping: Levenberg term - adds ``damping * diag(H)`` to the
            diagonal blocks each iteration.  Stabilizes the
            reference-compatible formulation (``exact_jacobians=False``,
            ``relinearize_omega=True``), whose GN otherwise wanders at
            hundreds of poses; 0 (default) is pure Gauss-Newton.
        super_size: super-block size S for the ``"tridiag"`` solver
            (poses per block-Thomas scan step).  Default ``band``.  The
            scan runs ``T1/S`` iterations of dense ``(3S, 3S)`` work:
            larger S trades per-iteration flops (O(S^3) Cholesky +
            inverse) against scan-iteration dispatch overhead, at
            ``~36*S`` bytes/pose of stacked carry memory.  Ignored by
            the other solvers.
        stall_ratio: optional progress criterion: stop GN once
            ``delta_sum > stall_ratio * previous delta_sum`` (no longer
            geometrically converging).  At trajectory scale the absolute
            ``delta_tol`` sits below the f32 solve-noise floor
            (``||dx||^2`` saturates at ~``(eps * ||x||)^2`` — at 1M
            poses on a 50 km course that is >> any meaningful tol), so
            absolute-threshold GN always runs to ``max_gn_iters``; the
            stall check stops it the first iteration that fails to
            shrink the step.  None (default) disables it.
        reuse_factorization: factor H once and solve every GN iteration
            by substitution.  Valid ONLY when H is constant across
            iterations: ``exact_jacobians=True`` (blocks are +/-Omega),
            ``relinearize_omega=False`` (Omega frozen at the initial
            guess), ``solver="tridiag"``.  Default None auto-enables it
            exactly in that configuration (bit-identical results: the
            staged factor/substitute runs the same ops in the same
            order; see :func:`slamsim.slam.tridiag.block_thomas_factor`).
            GN iterations after the first then cost an O(E + T1) rhs
            rebuild plus two O(S^2)-per-block substitution scans instead
            of the full O(S^3)-per-block factorization.
        refactor_every: make REFERENCE-SEMANTICS relinearization
            (``relinearize_omega=True``, graph_based_slam.py:411-417)
            affordable at scale: refresh Omega from the current poses and
            re-factor H only every k-th GN iteration, reusing the stale
            :class:`~slamsim.slam.tridiag.TridiagFlatFactor` (and the
            matching stale Omega in the rhs) in between.  Iterations
            between refreshes are inexact-Newton steps toward the SAME
            fixed point - the rhs at convergence is the relinearized
            gradient - so the solution matches full relinearization to
            solver tolerance while the per-iteration cost drops to the
            frozen-Omega reuse path's rhs-rebuild + substitution.
            ``refactor_every=1`` IS full relinearization (every
            iteration factors fresh).  Requires ``exact_jacobians=True``,
            ``relinearize_omega=True``, ``solver='tridiag'``.
        n_parts: partition the tridiag factor/substitution into that
            many batched chunks (single-chip SPIKE,
            :func:`slamsim.slam.tridiag.block_thomas_factor_partitioned`)
            - the sequential scan depth drops N -> N/n_parts + n_parts.
            Measured at 1M poses (C=32): substitutions 0.128 -> 0.045 s
            per GN iteration, but the FACTOR gets slower (0.92 ->
            1.37 s: the in-scan batched Cholesky serializes over the
            chunk batch), so this pays only when substitutions dominate
            (many GN iterations / rhs per factorization; the default
            4-iteration 1M solve keeps the sequential factor).
            Reuse-factorization path only; results agree with the
            sequential factor to solver roundoff (not bitwise).
            None = sequential.
    """
    if damping < 0.0:
        raise ValueError(f"damping must be >= 0, got {damping}; negative "
                         "damping subtracts from diag(H) and degrades "
                         "conditioning")
    can_reuse = (solver == "tridiag" and cfg.exact_jacobians
                 and not relinearize_omega)
    if reuse_factorization is None:
        reuse_factorization = can_reuse
    elif reuse_factorization and not can_reuse:
        raise ValueError(
            "reuse_factorization requires constant H: exact_jacobians="
            "True, relinearize_omega=False, solver='tridiag' (got "
            f"exact_jacobians={cfg.exact_jacobians}, relinearize_omega="
            f"{relinearize_omega}, solver={solver!r})")
    if refactor_every is not None:
        if refactor_every < 1:
            raise ValueError(
                f"refactor_every must be >= 1, got {refactor_every}")
        if not (solver == "tridiag" and cfg.exact_jacobians
                and relinearize_omega):
            raise ValueError(
                "refactor_every is the relinearize_omega=True fast path: "
                "requires exact_jacobians=True, relinearize_omega=True, "
                f"solver='tridiag' (got exact_jacobians="
                f"{cfg.exact_jacobians}, relinearize_omega="
                f"{relinearize_omega}, solver={solver!r}; with frozen "
                "Omega use reuse_factorization instead)")
    t1 = poses_init.shape[0]
    tol = cfg.delta_sum_threshold if delta_tol is None else delta_tol

    if n_parts is not None and not reuse_factorization:
        raise ValueError("n_parts (partitioned Thomas) is implemented "
                         "on the reuse_factorization path only")
    if reuse_factorization:
        return _graph_solve_banded_reuse(
            cfg, poses_init, obs, edges, band, rel_odom, odom_info,
            damping, super_size, tol, stall_ratio, n_parts)
    if refactor_every is not None:
        return _graph_solve_banded_relin_reuse(
            cfg, poses_init, obs, edges, band, rel_odom, odom_info,
            damping, super_size, tol, stall_ratio, refactor_every)

    def gn_body(carry):
        poses, _, _, iters, _ = carry
        omega_poses = poses if relinearize_omega else poses_init
        blocks = build_edge_blocks(cfg, poses, obs, edges,
                                   omega_poses=omega_poses)
        h_flat, b_flat, kept = assemble_banded_flat(cfg, blocks, edges,
                                                    t1, band)
        if rel_odom is not None:
            h_flat, b_flat = add_odometry_chain_flat(
                h_flat, b_flat, poses, rel_odom, odom_info)
            kept = jnp.ones_like(kept)  # the chain constrains every pose
        if damping:
            for k in (0, 4, 8):
                h_flat = h_flat.at[k].multiply(1.0 + damping)
        if solver == "tridiag":
            # Flat end-to-end: no (.., 3, 3)-trailing intermediates
            # (their tile-padded layouts OOM beyond ~150k poses).
            from slamsim.slam.tridiag import banded_solve_tridiag_flat

            delta = banded_solve_tridiag_flat(h_flat, -b_flat, band,
                                              super_size=super_size)
            cg_it = jnp.asarray(0)
        elif solver == "cr":
            # Flat end-to-end like tridiag (the latency-optimal solver
            # now scales past 150k too).
            from slamsim.slam.cyclic import banded_solve_cr_flat

            delta = banded_solve_cr_flat(h_flat, -b_flat, band)
            cg_it = jnp.asarray(0)
        elif solver == "cholesky":
            # Flat end-to-end (streaming (T1, D*9) scans): the exact
            # direct solver scales past 150k too.
            from slamsim.slam.cholesky import banded_solve_direct_flat

            delta = banded_solve_direct_flat(h_flat, -b_flat, band)
            cg_it = jnp.asarray(0)
        else:
            delta, cg_it = cg_solve_flat(h_flat, -b_flat, band,
                                         cg_iters, cg_tol)
        delta = delta * kept[:, None]
        poses = poses + delta
        poses = poses.at[:, 2].set(wrap_angle(poses[:, 2]))
        # Convergence metric on the wrap-invariant motion: a yaw that
        # flips representation across +/-pi moves by ~2*pi in raw delta
        # but by ~0 physically - raw deltas would keep GN at max_iters on
        # long courses whose yaws sweep the boundary.
        eff = delta.at[:, 2].set(wrap_angle(delta[:, 2]))
        return poses, jnp.sum(eff * eff), carry[1], iters + 1, cg_it

    gn_cond = _make_gn_cond(tol, cfg.max_gn_iters, stall_ratio)
    init = (poses_init, jnp.asarray(jnp.inf, poses_init.dtype),
            jnp.asarray(jnp.inf, poses_init.dtype),
            jnp.asarray(0), jnp.asarray(0))
    poses, delta_sum, _, iters, cg_it = jax.lax.while_loop(
        gn_cond, gn_body, init)
    return BandedSolveResult(poses=poses, gn_iters=iters,
                             delta_sum=delta_sum, cg_iters_last=cg_it)


def _make_gn_cond(tol, max_iters: int, stall_ratio: float | None):
    """GN while_loop condition over ``(poses, delta_sum, prev_delta_sum,
    iters, cg_it)`` carries: absolute threshold + iteration cap, plus the
    optional stall check (see ``graph_solve_banded`` ``stall_ratio``)."""

    def gn_cond(carry):
        _, delta_sum, prev, iters, _ = carry
        go = (delta_sum >= tol) & (iters < max_iters)
        if stall_ratio is not None:
            # Only meaningful once two real delta_sums exist (the carry
            # is seeded with inf/inf, and inf < ratio*inf is False).
            go = go & ((iters < 2) | (delta_sum < stall_ratio * prev))
        return go

    return gn_cond


def _graph_solve_banded_reuse(cfg: GraphConfig, poses_init,
                              obs: GraphObservations, edges: EdgeList,
                              band: int, rel_odom, odom_info,
                              damping: float, super_size: int | None,
                              tol, stall_ratio: float | None,
                              n_parts: int | None = None):
    """Factor-reuse GN: constant-H fast path of :func:`graph_solve_banded`.

    H is assembled and Thomas-factored ONCE (the O(S^3)-per-block cost);
    the while_loop body rebuilds only the rhs from the current poses and
    back-substitutes.  Valid exactly when ``exact_jacobians=True`` and
    ``relinearize_omega=False`` (see the caller's guard); results are
    bit-identical to the one-shot path, which re-factors the same H
    every iteration.
    """
    from slamsim.slam.tridiag import (banded_factor_tridiag_flat,
                                      banded_resolve_tridiag_flat)

    t1 = poses_init.shape[0]
    ss = max(band, 1) if super_size is None else super_size
    om, rel_obs, mask = exact_edge_terms(cfg, obs, edges, poses_init)
    zeros_b = jnp.zeros((om.shape[0], 3), om.dtype)
    blocks = {"h_bb": om, "h_ba": -om, "h_aa": om,
              "b_b": zeros_b, "b_a": zeros_b, "mask": mask}
    h_flat, _, kept = assemble_banded_flat(cfg, blocks, edges, t1, band)
    if rel_odom is not None:
        h_flat, _ = add_odometry_chain_flat(
            h_flat, jnp.zeros((3, t1), h_flat.dtype), poses_init,
            rel_odom, odom_info)
        kept = jnp.ones_like(kept)
    if damping:
        for k in (0, 4, 8):
            h_flat = h_flat.at[k].multiply(1.0 + damping)
    fac = banded_factor_tridiag_flat(h_flat, band, ss, n_parts=n_parts)

    def gn_body(carry):
        poses, delta_prev, _, iters, _ = carry
        b_flat = exact_rhs_flat(poses, om, rel_obs, edges, t1)
        if rel_odom is not None:
            b_flat = odometry_rhs_flat(b_flat, poses, rel_odom, odom_info)
        delta = banded_resolve_tridiag_flat(fac, -b_flat, ss)
        delta = delta * kept[:, None]
        poses = poses + delta
        poses = poses.at[:, 2].set(wrap_angle(poses[:, 2]))
        eff = delta.at[:, 2].set(wrap_angle(delta[:, 2]))
        return (poses, jnp.sum(eff * eff), delta_prev, iters + 1,
                jnp.asarray(0))

    gn_cond = _make_gn_cond(tol, cfg.max_gn_iters, stall_ratio)
    init = (poses_init, jnp.asarray(jnp.inf, poses_init.dtype),
            jnp.asarray(jnp.inf, poses_init.dtype),
            jnp.asarray(0), jnp.asarray(0))
    poses, delta_sum, _, iters, cg_it = jax.lax.while_loop(
        gn_cond, gn_body, init)
    return BandedSolveResult(poses=poses, gn_iters=iters,
                             delta_sum=delta_sum, cg_iters_last=cg_it)


def _graph_solve_banded_relin_reuse(cfg: GraphConfig, poses_init,
                                    obs: GraphObservations,
                                    edges: EdgeList, band: int, rel_odom,
                                    odom_info, damping: float,
                                    super_size: int | None, tol,
                                    stall_ratio: float | None,
                                    refactor_every: int):
    """Refactor-every-k GN for REFERENCE-SEMANTICS relinearization.

    The reference recomputes the measurement information from the current
    estimates every GN iteration (graph_based_slam.py:411-417), which at
    scale forfeits factor reuse entirely (every iteration pays the
    O(S^3)-per-block Thomas factorization).  This loop refreshes
    ``om = Omega(poses)`` + the factorization only when
    ``iters % refactor_every == 0``; between refreshes it runs the cheap
    rhs-rebuild + substitution of the frozen-Omega path against the stale
    factor AND the stale ``om`` (so each inter-refresh segment is an
    exact GN on the stale linearization; the refresh then re-anchors it).
    ``refactor_every=1`` degenerates to full per-iteration
    relinearization.  Fixed point: a converged rhs is
    ``J' Omega(stale poses ~= final poses) err(final poses) = 0`` - the
    same stationarity full relinearization converges to, so poses match
    to solver tolerance (pinned by tests/test_large_graph.py).
    """
    from slamsim.slam.tridiag import (banded_factor_tridiag_flat,
                                      banded_resolve_tridiag_flat)

    t1 = poses_init.shape[0]
    ss = max(band, 1) if super_size is None else super_size
    # rel_obs and mask are pose-independent; only om refreshes.
    om0, rel_obs, mask = exact_edge_terms(cfg, obs, edges, poses_init)
    kept_zero_b = jnp.zeros((om0.shape[0], 3), om0.dtype)

    def factor_at(om, poses):
        blocks = {"h_bb": om, "h_ba": -om, "h_aa": om,
                  "b_b": kept_zero_b, "b_a": kept_zero_b, "mask": mask}
        h_flat, _, kept = assemble_banded_flat(cfg, blocks, edges, t1,
                                               band)
        if rel_odom is not None:
            h_flat, _ = add_odometry_chain_flat(
                h_flat, jnp.zeros((3, t1), h_flat.dtype), poses,
                rel_odom, odom_info)
            kept = jnp.ones_like(kept)
        if damping:
            for k in (0, 4, 8):
                h_flat = h_flat.at[k].multiply(1.0 + damping)
        return banded_factor_tridiag_flat(h_flat, band, ss), kept

    fac0, kept = factor_at(om0, poses_init)

    def refresh(poses):
        om = exact_edge_omega(cfg, obs, edges, poses, mask)
        fac, _ = factor_at(om, poses)  # kept is pose-independent
        return om, fac

    def gn_body(carry):
        poses, delta_prev, prev2, iters, om, fac = carry
        do_refresh = (iters > 0) & (iters % refactor_every == 0)
        om, fac = jax.lax.cond(do_refresh, refresh,
                               lambda p: (om, fac), poses)
        b_flat = exact_rhs_flat(poses, om, rel_obs, edges, t1)
        if rel_odom is not None:
            b_flat = odometry_rhs_flat(b_flat, poses, rel_odom, odom_info)
        delta = banded_resolve_tridiag_flat(fac, -b_flat, ss)
        delta = delta * kept[:, None]
        poses = poses + delta
        poses = poses.at[:, 2].set(wrap_angle(poses[:, 2]))
        eff = delta.at[:, 2].set(wrap_angle(delta[:, 2]))
        return (poses, jnp.sum(eff * eff), delta_prev, iters + 1, om, fac)

    base_cond = _make_gn_cond(tol, cfg.max_gn_iters, stall_ratio)

    def gn_cond(carry):
        return base_cond(carry[:5])

    init = (poses_init, jnp.asarray(jnp.inf, poses_init.dtype),
            jnp.asarray(jnp.inf, poses_init.dtype), jnp.asarray(0),
            om0, fac0)
    poses, delta_sum, _, iters, _, _ = jax.lax.while_loop(
        gn_cond, gn_body, init)
    return BandedSolveResult(poses=poses, gn_iters=iters,
                             delta_sum=delta_sum,
                             cg_iters_last=jnp.asarray(0))
