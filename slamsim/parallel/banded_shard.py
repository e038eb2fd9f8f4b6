"""Pose-sharded banded CG: the solver itself distributed over the mesh.

:mod:`slamsim.parallel.graph_shard` shards edge ASSEMBLY and runs the
solve replicated - fine while one device holds the whole ``(D, T1, 3, 3)``
band.  For very long trajectories the band itself outgrows a chip
(T1 = 1M poses at D = 41 is ~1.5 GB in f32), and the solve becomes the
scaling wall.  This module shards the system by BLOCK ROWS of H over the
mesh - the trajectory analog of sequence parallelism:

  * each device owns ``T1 / n_dev`` consecutive pose rows of ``h_band``,
    ``b``, and the iterate ``x``;
  * one banded matvec needs ``D - 1`` halo rows of ``x`` from each
    neighbor - exchanged with two ``jax.lax.ppermute`` shifts
    (zero-fill at the chain ends = the zero boundary of the band);
  * the ``H`` halo (last ``D - 1`` band rows of the LEFT neighbor, for
    the transposed lower half) is exchanged ONCE per solve - H is fixed
    across CG iterations;
  * CG dot products are ``psum`` scalars; the block-Jacobi preconditioner
    is device-local.

Communication per iteration: 2 shifts of ``(D-1, 3)`` floats + 3 scalar
psums - O(band), independent of T1, between neighbor devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slamsim.core.precision import highest_matmul_precision
from slamsim.parallel.mesh import ROLLOUT_AXIS
from slamsim.slam.graph import _inv3x3


def _shift_from_right(x, axis_name, n_dev):
    """Each device receives ``x`` from its RIGHT neighbor (device i gets
    device i+1's value); the last device receives zeros."""
    if n_dev == 1:
        return jnp.zeros_like(x)
    return jax.lax.ppermute(x, axis_name,
                            perm=[(i, i - 1) for i in range(1, n_dev)])


def _shift_from_left(x, axis_name, n_dev):
    """Each device receives ``x`` from its LEFT neighbor; the first
    device receives zeros."""
    if n_dev == 1:
        return jnp.zeros_like(x)
    return jax.lax.ppermute(x, axis_name,
                            perm=[(i, i + 1) for i in range(n_dev - 1)])


def _local_banded_matvec_factory(h_local, h_left_halo, row0, t1, axis_name,
                                 n_dev):
    """Build the sharded ``x_local -> (H x)_local`` closure.

    Args:
        h_local: ``(D, L, 3, 3)`` this device's band rows (upper storage:
            ``h[d, i] = H[row0+i, row0+i+d]``).
        h_left_halo: ``(D, K, 3, 3)`` the left neighbor's LAST ``K = D-1``
            band rows (zeros on device 0).
        row0: this device's first global row (traced per-device scalar).
        t1: global row count (static).

    The returned closure exchanges the ``x`` halos (2 ppermutes) and does
    the band contraction as two gathers + two einsums, exactly like the
    single-device :func:`slamsim.slam.large.make_banded_matvec`.
    """
    d1, ell = h_local.shape[0], h_local.shape[1]
    k = d1 - 1
    if k == 0:
        def matvec_diag(x):
            return jnp.einsum("tij,tj->ti", h_local[0], x)
        return matvec_diag

    offs = jnp.arange(d1)[:, None]  # (D, 1)
    rows = jnp.arange(ell)[None, :]  # (1, L)
    grows = row0 + rows  # global row ids (1, L)

    # Upper half: y[i] += sum_d h[d, i] @ x[i + d].  In the extended
    # local vector x_ext = [left_halo (K) | x (L) | right_halo (K)],
    # global row g maps to position K + (g - row0).
    idx_u = k + rows + offs  # (D, L) into x_ext
    valid_u = ((grows + offs) < t1)[..., None]
    h_up = jnp.where(valid_u[..., None], h_local, 0.0)

    # Lower half: y[j] += sum_{d>=1} h[d, j - d]^T @ x[j - d].  Band row
    # j - d lives locally for j - d >= row0, else in the left halo
    # (h_left_halo[d, K - (row0 - (j - d))]).  Build the per-(d, j)
    # block table once - H is fixed for the whole solve.
    h_ext = jnp.concatenate([h_left_halo, h_local], axis=1)  # (D, K+L)
    idx_h = k + rows - offs  # (D, L) into h_ext's row axis
    valid_l = ((grows - offs) >= 0) & (offs >= 1)
    idx_h_c = jnp.clip(idx_h, 0, k + ell - 1)
    h_low = jnp.swapaxes(
        jnp.take_along_axis(h_ext, idx_h_c[..., None, None], axis=1),
        -1, -2) * valid_l[..., None, None]
    idx_l = k + rows - offs  # same positions, into x_ext
    idx_l = jnp.clip(idx_l, 0, 2 * k + ell - 1)

    def matvec(x):
        left = _shift_from_left(x[-k:], axis_name, n_dev)
        right = _shift_from_right(x[:k], axis_name, n_dev)
        x_ext = jnp.concatenate([left, x, right], axis=0)
        xu = x_ext[idx_u]
        xl = x_ext[idx_l] * valid_l[..., None]
        return (jnp.einsum("dtij,dtj->ti", h_up, xu)
                + jnp.einsum("dtij,dtj->ti", h_low, xl))

    return matvec


def sharded_cg_local(h_local, b_local, row0, t1, n_dev, max_iters, tol,
                     axis_name=ROLLOUT_AXIS):
    """Device-local body of the pose-sharded PCG (must run inside
    shard_map over ``axis_name`` with ``h_local (D, L, 3, 3)`` /
    ``b_local (L, 3)`` this device's block rows).

    Returns ``(x_full, iters)`` with ``x_full`` the all-gathered
    replicated solution.
    """
    from slamsim.core.pcg import pcg

    k = h_local.shape[0] - 1
    if k > 0:
        h_left_halo = _shift_from_left(h_local[:, -k:], axis_name, n_dev)
    else:
        h_left_halo = h_local[:, :0]
    matvec = _local_banded_matvec_factory(
        h_local, h_left_halo, row0, t1, axis_name, n_dev)
    minv = _inv3x3(h_local[0])

    def precond(r):
        return jnp.einsum("tij,tj->ti", minv, r)

    def gdot(a, c):
        return jax.lax.psum(jnp.sum(a * c), axis_name)

    x, iters = pcg(matvec, precond, gdot, b_local, max_iters, tol)
    return jax.lax.all_gather(x, axis_name, tiled=True), iters


@highest_matmul_precision
def sharded_cg_solve(mesh, h_band, b, max_iters: int = 200,
                     tol: float = 1e-8):
    """Block-Jacobi PCG on a pose-sharded banded system.

    The multi-chip twin of :func:`slamsim.slam.large.cg_solve` - same
    math, same stopping rule, but ``h_band``/``b``/the iterate are
    sharded by block rows over the mesh's rollout axis and the banded
    matvec exchanges halos with its neighbors.

    Args:
        mesh: mesh with axis ``rollout`` (n_dev must divide T1, and
            each shard must cover at least the bandwidth ``D - 1``).
        h_band: ``(D, T1, 3, 3)`` upper band (replicated or sharded on
            axis 1 - the in_spec shards it).
        b: ``(T1, 3)`` right-hand side.

    Returns:
        ``(x, iters)`` - the replicated solution of ``H x = b``.
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    n_dev = mesh.shape[ROLLOUT_AXIS]
    k = d1 - 1
    if t1 % n_dev:
        raise ValueError(f"T1={t1} not divisible by mesh size {n_dev}")
    ell = t1 // n_dev
    if n_dev > 1 and ell < k:
        raise ValueError(
            f"shard rows {ell} < bandwidth {k}: halo would span more "
            f"than one neighbor; use fewer devices or a narrower band")

    def local(h_local, b_local):
        row0 = jax.lax.axis_index(ROLLOUT_AXIS) * ell
        return sharded_cg_local(h_local, b_local, row0, t1, n_dev,
                                max_iters, tol)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, ROLLOUT_AXIS), P(ROLLOUT_AXIS)),
        out_specs=(P(), P()),
        check_vma=False)
    return fn(h_band, b)
