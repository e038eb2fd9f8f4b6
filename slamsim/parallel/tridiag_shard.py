"""Pose-sharded super-block Thomas: the PRODUCTION banded solver
distributed over the mesh.

:mod:`slamsim.parallel.banded_shard` shards block-Jacobi CG; this module
shards the direct solver the single-device path actually uses
(:func:`slamsim.slam.tridiag.banded_solve_tridiag_flat`), by
substructuring (the SPIKE / domain-decomposition form of block Thomas):

  * each device owns ``T1 / n_dev`` consecutive pose columns of the flat
    ``((band+1)*9, T1)`` entry storage - a contiguous run of ``m``
    super-blocks; the LAST super-block of each chunk is its INTERFACE;
  * the chunk's ``m - 1`` interior super-blocks are eliminated with ONE
    local multi-RHS block-Thomas pass (rhs = the two interface coupling
    columns + the local b), concurrently on every device - sequential
    depth drops from ``N`` to ``N / n_dev``;
  * the eliminated interiors induce a block-tridiagonal REDUCED system
    over the ``n_dev`` interface blocks; its per-chunk Schur
    contributions (three ``3S x 3S`` blocks + two vectors per device)
    ride one ``all_gather``, and every device solves the tiny
    replicated reduced system identically (deterministic);
  * interior solutions follow by local back-substitution - zero further
    communication.

Communication per solve: one ppermute of a ``3S x 3S`` coupling block +
one ppermute of a ``(3, band)`` prescale halo + one all_gather of
``O(n_dev * (3S)^2)`` floats - independent of T1.

Math (interfaces ``s_d`` = last super-block of chunk d, interiors
``u_d``): eliminating ``T_d u_d + V_d s_{d-1} + W_d s_d = g_d`` with
``V_d = e_0 (x) C_{d-1}^T`` (``C_{d-1}`` = the upper coupling of chunk
d-1's interface, received from it) and ``W_d = e_{m-2} (x) B_d`` gives
the reduced entries

  Shat_d     = S_d - B_d^T [T_d^{-1} W_d]_{m-2} - C_d [T_{d+1}^{-1} V_{d+1}]_0
  Shat_{d,d+1} = -C_d [T_{d+1}^{-1} W_{d+1}]_0
  bhat_d     = f_d - B_d^T [T_d^{-1} g_d]_{m-2} - C_d [T_{d+1}^{-1} g_{d+1}]_0

and back-substitution ``u_d = T_d^{-1} g_d - [T_d^{-1} V_d] s_{d-1} -
[T_d^{-1} W_d] s_d``.  All ``T_d^{-1}`` applications share one
factorization via the multi-row-RHS form of
:func:`slamsim.slam.tridiag.block_thomas_solve`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slamsim.core.precision import highest_matmul_precision
from slamsim.parallel.banded_shard import (_shift_from_left,
                                           _shift_from_right)
from slamsim.parallel.mesh import ROLLOUT_AXIS
from slamsim.slam.tridiag import (_flat_to_tridiag, block_thomas_solve,
                                  flat_rows_to_super, pad_flat,
                                  super_rows_to_flat)


def _flat_prescale_local(h_flat, b_flat, band: int, axis_name, n_dev):
    """Shard-local twin of :func:`slamsim.slam.tridiag._flat_prescale`.

    The scale column for entry ``(i, i+d)`` needs ``s`` at ``i + d`` up
    to ``band`` past the chunk end: one ppermute fetches the right
    neighbor's first ``band`` columns; the last device clamps (repeats
    its final column), matching the single-device global clamp.
    """
    d1 = band + 1
    ell = h_flat.shape[1]
    diag = jnp.stack([h_flat[0], h_flat[4], h_flat[8]])  # (3, L)
    s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
    halo = _shift_from_right(s[:, :band], axis_name, n_dev)  # zeros @ last
    d_idx = jax.lax.axis_index(axis_name)
    clamp = jnp.repeat(s[:, -1:], band, axis=1)
    halo = jnp.where(d_idx == n_dev - 1, clamp, halo)
    s_ext = jnp.concatenate([s, halo], axis=1)  # (3, L + band)
    s_shift = jnp.stack([
        jax.lax.dynamic_slice_in_dim(s_ext, d, ell, axis=1)
        for d in range(d1)])  # (D, 3, L)
    s_a = jnp.tile(jnp.repeat(s, 3, axis=0)[None], (d1, 1, 1))
    s_b = jnp.tile(s_shift, (1, 3, 1))
    scale = (s_a * s_b).reshape(d1 * 9, ell)
    return h_flat * scale, b_flat * s, s


def _sharded_thomas_local(diag, upper, b_sup, axis_name, n_dev):
    """Device-local substructured Thomas (run inside shard_map).

    Args:
        diag: ``(m, 3S, 3S)`` this chunk's super-block diagonals.
        upper: ``(m, 3S, 3S)``; ``upper[m-1]`` is the live coupling into
            the NEXT chunk (zero on the last device).
        b_sup: ``(m, 3S)`` interleaved local rhs.

    Returns:
        ``(m, 3S)`` this chunk's solution super-rows.
    """
    m, s3 = diag.shape[0], diag.shape[1]
    if m < 2:
        raise ValueError(f"need >= 2 super-blocks per device, got {m}")

    # C_{d-1}: the left neighbor's interface coupling (zeros on dev 0).
    c_in = _shift_from_left(upper[m - 1], axis_name, n_dev)  # (3S, 3S)
    big_b = upper[m - 2]  # B_d: last interior -> interface coupling

    # One multi-RHS interior solve: rows [0:3S) = V columns (row-form:
    # R[0] = C), [3S:6S) = W columns (R[m-2] = B^T), row 6S = g.
    n_rhs = 2 * s3 + 1
    rhs = jnp.zeros((m - 1, n_rhs, s3), diag.dtype)
    rhs = rhs.at[0, 0:s3].set(c_in)
    rhs = rhs.at[m - 2, s3:2 * s3].set(big_b.T)
    rhs = rhs.at[:, 2 * s3].set(b_sup[:m - 1])
    z = block_thomas_solve(diag[:m - 1], upper[:m - 2], rhs)
    zc = z[:, 0:s3]  # [T^{-1} V] as rows: G_k = zc[k].T
    zb = z[:, s3:2 * s3]
    zg = z[:, 2 * s3]  # (m-1, 3S)

    # Per-chunk Schur contributions to the reduced interface system.
    diag_own = diag[m - 1] - big_b.T @ zb[m - 2].T
    diag_left = -c_in @ zc[0].T  # belongs to interface d-1
    coup_left = -c_in @ zb[0].T  # coupling (d-1, d)
    rhs_own = b_sup[m - 1] - zg[m - 2] @ big_b
    rhs_left = -zg[0] @ c_in.T

    # One gather; the reduced solve is replicated (identical on every
    # device -> deterministic, no broadcast needed).
    ag = jax.lax.all_gather(
        (diag_own, diag_left, coup_left, rhs_own, rhs_left), axis_name)
    g_down, g_dleft, g_coup, g_rown, g_rleft = ag

    def from_next(x):  # entry d <- chunk d+1's contribution
        return jnp.concatenate(
            [x[1:], jnp.zeros_like(x[:1])], axis=0)

    red_diag = g_down + from_next(g_dleft)
    red_upper = g_coup[1:]
    red_b = g_rown + from_next(g_rleft)
    s_rows = block_thomas_solve(red_diag, red_upper, red_b)  # (n_dev, 3S)

    d_idx = jax.lax.axis_index(axis_name)
    s_own = s_rows[d_idx]
    s_prev = jnp.where(d_idx == 0, jnp.zeros((s3,), s_rows.dtype),
                       s_rows[jnp.maximum(d_idx - 1, 0)])

    # Back-substitution: u = T^{-1}g - [T^{-1}V] s_prev - [T^{-1}W] s_own
    # (row form: G_k s = s @ zc[k]).
    u = (zg - jnp.einsum("c,kcm->km", s_prev, zc)
         - jnp.einsum("c,kcm->km", s_own, zb))
    return jnp.concatenate([u, s_own[None]], axis=0)


def sharded_tridiag_local(h_loc, b_loc, band: int, super_size: int,
                          axis_name, n_dev: int):
    """Shard-local flat solve (run inside shard_map over ``axis_name``).

    ``h_loc ((band+1)*9, L)`` / ``b_loc (3, L)`` are this device's pose
    columns with ``L`` a multiple of ``super_size`` and at least two
    super-blocks.  Returns the local ``(3, L)`` solution columns.
    """
    with jax.default_matmul_precision("highest"):
        h_s, b_s, s = _flat_prescale_local(h_loc, b_loc, band,
                                           axis_name, n_dev)
        diag, upper = _flat_to_tridiag(h_s, band, super_size,
                                       drop_last=False)
        b_sup = flat_rows_to_super(b_s, super_size)
        x_sup = _sharded_thomas_local(diag, upper, b_sup, axis_name,
                                      n_dev)
        return super_rows_to_flat(x_sup, super_size) * s


@highest_matmul_precision
def sharded_banded_solve_tridiag_flat(mesh, h_flat, b_flat, band: int,
                                      super_size: int | None = None,
                                      axis_name: str = ROLLOUT_AXIS):
    """Pose-sharded ``H x = b`` on flat banded storage.

    The multi-chip twin of
    :func:`slamsim.slam.tridiag.banded_solve_tridiag_flat`: same
    prescale / densify / Thomas math, but the trajectory axis is sharded
    over ``mesh``'s ``axis_name`` and the sequential elimination runs
    concurrently per chunk with a tiny gathered interface solve (module
    docstring).  Pads T1 to a multiple of ``n_dev * super_size`` with
    decoupled identity scalar blocks.

    Args:
        mesh: mesh whose ``axis_name`` axis shards poses.
        h_flat: ``((band+1)*9, T1)`` flat upper-band entries.
        b_flat: ``(3, T1)`` rhs rows.

    Returns:
        ``(T1, 3)`` solution (replicated).
    """
    t1 = h_flat.shape[1]
    if super_size is None:
        super_size = max(band, 1)
    if band > super_size:
        raise ValueError(f"band {band} exceeds super size {super_size}")
    n_dev = mesh.shape[axis_name]
    h_flat, b_flat = pad_flat(h_flat, b_flat, n_dev * super_size)
    if h_flat.shape[1] // (n_dev * super_size) < 2:
        # Fewer than 2 super-blocks per device: pad up to the minimum.
        h_flat, b_flat = pad_flat(h_flat, b_flat, 2 * n_dev * super_size)

    def local(h_loc, b_loc):
        return sharded_tridiag_local(h_loc, b_loc, band, super_size,
                                     axis_name, n_dev)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis_name), P(None, axis_name)),
        out_specs=P(None, axis_name),
        check_vma=False)
    x3 = fn(h_flat, b_flat)
    return x3.T[:t1]
