"""Edge-sharded graph-SLAM assembly: the 'constraint parallel' axis.

The dominant cost of a large graph solve is edge-block construction +
scatter-add assembly over millions of constraints (see
``slamsim.slam.large``).  Constraints are independent, so they shard
perfectly: each device builds and locally assembles its slice of the edge
list into banded ``(H, b)`` partials, which a ``psum`` combines
into the replicated global system; the (much cheaper) preconditioned CG
solve then runs replicated.  This is the framework's analog of
sequence/context parallelism - the trajectory's constraint set, not a
sequence of tokens, is what gets sliced (SURVEY.md section 2: "sharding
the graph-SLAM information matrix blocks across devices").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slamsim.core.angles import wrap_angle
from slamsim.core.precision import highest_matmul_precision
from slamsim.parallel.mesh import ROLLOUT_AXIS, psum_hierarchical
from slamsim.slam.graph import GraphConfig, GraphObservations
from slamsim.slam.large import (EdgeList, add_odometry_chain,
                                add_odometry_chain_flat, assemble_banded,
                                assemble_banded_flat, build_edge_blocks,
                                cg_solve)


def _anchor_extras(cfg: GraphConfig, kept, dtype):
    """Per-pose scalar the assembly adds to each diagonal entry beyond
    the edge blocks: identity padding on non-kept poses + the gauge
    anchor at the first kept pose (zero everywhere if nothing is kept).

    The sharded assembly SUBTRACTS this for the shard-local ``kept``
    (local-visibility artifacts) before the reduction and ADDS it back
    for the globally-reduced ``kept`` after - one law for both layouts
    and both directions.
    """
    extra = jnp.where(kept, jnp.zeros((), dtype), jnp.ones((), dtype))
    fk = jnp.argmax(kept)
    return extra.at[fk].add(jnp.where(jnp.any(kept), cfg.anchor, 0.0))


def pad_edges(edges: EdgeList, multiple: int) -> EdgeList:
    """Pad the edge list with invalid slots to a device-count multiple."""
    e = edges.t_b.shape[0]
    pad = (-e) % multiple
    if pad == 0:
        return edges
    z = jnp.zeros((pad,), edges.t_b.dtype)
    return EdgeList(
        t_b=jnp.concatenate([edges.t_b, z]),
        t_a=jnp.concatenate([edges.t_a, z]),
        lm=jnp.concatenate([edges.lm, z]),
        valid=jnp.concatenate([edges.valid,
                               jnp.zeros((pad,), bool)]))


@highest_matmul_precision
def sharded_gn_iteration(cfg: GraphConfig, mesh, poses,
                         obs: GraphObservations, edges: EdgeList,
                         band: int, rel_odom=None,
                         odom_info=(100.0, 100.0, 400.0),
                         cg_iters: int = 200, cg_tol: float = 1e-8,
                         solver: str = "cg",
                         slice_axis: str | None = None):
    """One Gauss-Newton iteration with edge-sharded assembly.

    Edges are sharded over the mesh's rollout axis; poses/observations are
    replicated (they are O(T) vs the edges' O(E) >> O(T)).  Assembly
    partials meet in a single psum.

    Args:
        solver: ``"cg"`` solves replicated (every device runs the whole
            CG); ``"sharded_cg"`` solves pose-sharded over the SAME mesh
            axis (each device iterates on its block rows with halo
            exchange, :mod:`slamsim.parallel.banded_shard`);
            ``"sharded_tridiag"`` solves pose-sharded with the PRODUCTION
            direct solver (substructured super-block Thomas,
            :mod:`slamsim.parallel.tridiag_shard`) - assembly stays on
            the flat entry layout end-to-end, so this is the path that
            scales to very long trajectories.  Requires ``n_dev | T1``;
            CG shards at least ``band`` rows wide, tridiag at least two
            ``band``-sized super-blocks.

        slice_axis: outer mesh axis over groups of devices
            (:data:`slamsim.parallel.mesh.SLICE_AXIS`).  Edges then
            shard over ``slice x rollout`` and the assembly reduction is
            hierarchical (psum within a group, one combined banded
            system per group across groups); the pose-sharded solvers
            keep their halo exchanges INSIDE a group and run
            replicated across groups - the slow links carry no
            per-iteration traffic.

    Returns ``(new_poses, delta_sum, cg_iters)`` (replicated).
    """
    t1 = poses.shape[0]
    n_dev = mesh.shape[ROLLOUT_AXIS]
    edge_axes = (ROLLOUT_AXIS,) if slice_axis is None else (
        slice_axis, ROLLOUT_AXIS)
    n_edge_shards = n_dev if slice_axis is None else (
        n_dev * mesh.shape[slice_axis])

    def _reduce(v):
        return psum_hierarchical(v, ROLLOUT_AXIS, slice_axis)

    if solver == "sharded_cg":
        if t1 % n_dev:
            raise ValueError(f"T1={t1} not divisible by {n_dev} devices")
        if n_dev > 1 and t1 // n_dev < band:
            raise ValueError(
                f"shard rows {t1 // n_dev} < band {band}: halo would "
                f"span more than one neighbor")
    if solver == "sharded_tridiag":
        super_size = max(band, 1)
        if t1 % (n_dev * super_size) or t1 // (n_dev * super_size) < 2:
            raise ValueError(
                f"T1={t1} must give each of {n_dev} devices >= 2 "
                f"super-blocks of {super_size} poses")
    edges = pad_edges(edges, n_edge_shards)

    def local(poses, t_b, t_a, lm, valid):
        el = EdgeList(t_b, t_a, lm, valid)
        blocks = build_edge_blocks(cfg, poses, obs, el)
        if solver == "sharded_tridiag":
            # Flat entry layout end-to-end (no (.., 3, 3)-trailing
            # intermediates; see slamsim.slam.tridiag module docstring).
            h_flat, b_flat, kept = assemble_banded_flat(
                cfg, blocks, el, t1, band)
            # Strip per-shard anchor/padding before the reduction
            # (local-visibility artifacts; re-derived globally below).
            ex = _anchor_extras(cfg, kept, h_flat.dtype)
            for k in (0, 4, 8):
                h_flat = h_flat.at[k].add(-ex)

            kept_cnt = _reduce(kept.astype(jnp.int32))
            h_flat = _reduce(h_flat)
            b_flat = _reduce(b_flat)

            kept_g = kept_cnt > 0
            ex_g = _anchor_extras(cfg, kept_g, h_flat.dtype)
            for k in (0, 4, 8):
                h_flat = h_flat.at[k].add(ex_g)

            if rel_odom is not None:
                h_flat, b_flat = add_odometry_chain_flat(
                    h_flat, b_flat, poses, rel_odom, odom_info)
                kept_g = jnp.ones_like(kept_g)

            from slamsim.parallel.tridiag_shard import (
                sharded_tridiag_local)

            ell = t1 // n_dev
            col0 = jax.lax.axis_index(ROLLOUT_AXIS) * ell
            h_loc = jax.lax.dynamic_slice_in_dim(h_flat, col0, ell,
                                                 axis=1)
            b_loc = jax.lax.dynamic_slice_in_dim(-b_flat, col0, ell,
                                                 axis=1)
            x3_loc = sharded_tridiag_local(h_loc, b_loc, band,
                                           super_size, ROLLOUT_AXIS,
                                           n_dev)
            delta = jax.lax.all_gather(
                x3_loc, ROLLOUT_AXIS, axis=1, tiled=True).T
            cg_it = jnp.asarray(0)
            delta = delta * kept_g[:, None]
            new_poses = poses + delta
            new_poses = new_poses.at[:, 2].set(
                wrap_angle(new_poses[:, 2]))
            return new_poses, jnp.sum(delta * delta), cg_it

        h_band, bvec, kept = assemble_banded(cfg, blocks, el, t1, band)
        # Same strip / reduce / re-derive as the flat branch, applied to
        # the (D, T1, 3, 3) diagonal blocks.
        eye = jnp.eye(3, dtype=h_band.dtype)
        ex = _anchor_extras(cfg, kept, h_band.dtype)
        h_band = h_band.at[0].add(-ex[:, None, None] * eye)

        kept_cnt = _reduce(kept.astype(jnp.int32))
        h_band = _reduce(h_band)
        bvec = _reduce(bvec)

        kept_g = kept_cnt > 0
        ex_g = _anchor_extras(cfg, kept_g, h_band.dtype)
        h_band = h_band.at[0].add(ex_g[:, None, None] * eye)

        if rel_odom is not None:
            h_band, bvec = add_odometry_chain(h_band, bvec, poses,
                                              rel_odom, odom_info)
            kept_g = jnp.ones_like(kept_g)

        if solver == "sharded_cg":
            from slamsim.parallel.banded_shard import sharded_cg_local

            ell = t1 // n_dev
            row0 = jax.lax.axis_index(ROLLOUT_AXIS) * ell
            h_local = jax.lax.dynamic_slice_in_dim(h_band, row0, ell,
                                                   axis=1)
            b_local = jax.lax.dynamic_slice_in_dim(-bvec, row0, ell,
                                                   axis=0)
            delta, cg_it = sharded_cg_local(h_local, b_local, row0, t1,
                                            n_dev, cg_iters, cg_tol)
        else:
            delta, cg_it = cg_solve(h_band, -bvec, cg_iters, cg_tol)
        delta = delta * kept_g[:, None]
        new_poses = poses + delta
        new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
        return new_poses, jnp.sum(delta * delta), cg_it

    e_spec = P(edge_axes)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), e_spec, e_spec, e_spec, e_spec),
        out_specs=(P(), P(), P()),
        check_vma=False)
    return fn(poses, edges.t_b, edges.t_a, edges.lm, edges.valid)


def sharded_graph_solve(cfg: GraphConfig, mesh, poses_init,
                        obs: GraphObservations, edges: EdgeList, band: int,
                        max_iters: int | None = None, delta_tol=None,
                        **iteration_kwargs):
    """Full Gauss-Newton with edge-sharded assembly.

    Iterates :func:`sharded_gn_iteration` (outer loop on the host: each
    iteration is one jitted SPMD program) until ``||dx||^2 < delta_tol``
    or ``max_iters``.  The multi-chip twin of
    :func:`slamsim.slam.large.graph_solve_banded`.

    Returns ``(poses, n_iters, last_delta_sum)``.
    """
    if max_iters is None:
        max_iters = cfg.max_gn_iters
    if delta_tol is None:
        delta_tol = cfg.delta_sum_threshold
    step = jax.jit(lambda p: sharded_gn_iteration(
        cfg, mesh, p, obs, edges, band, **iteration_kwargs))
    poses = poses_init
    delta_sum = float("inf")
    it = 0
    while it < max_iters and delta_sum >= delta_tol:
        poses, ds, _ = step(poses)
        delta_sum = float(ds)
        it += 1
    return poses, it, delta_sum
