"""Blocked banded Cholesky: exact direct solver for the graph system.

The deliverable SURVEY.md section 7.6 names for the 10k-pose solve
(BASELINE config 5): factor the block-banded information matrix H
(storage ``hb[d, i] = H[i, i+d]``, d in [0, band]) as L L^T with L in the
same lower-band structure, then solve by forward/backward substitution.

Complexity O(T * band^2) flops - versus the reference's dense O((3T)^3)
inverse (graph_based_slam.py:497) - with all inner algebra as 3x3-block
operations vectorized over the band, so each of the T sequential scan
steps is one fused elementwise pass.  Unlike CG (``large.py::cg_solve``) the cost
is independent of conditioning; use it when H's band is moderate and the
spectrum is nasty, CG when the band is wide or H is only available as a
matvec.

All loops are ``lax.scan`` with sliding-window carries - no dynamic
shapes, jit-friendly end to end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slamsim.core.precision import highest_matmul_precision


def _chol3(a):
    """Closed-form Cholesky of (..., 3, 3) SPD blocks (no LAPACK)."""
    eps = 1e-30
    a00 = jnp.maximum(a[..., 0, 0], eps)
    l00 = jnp.sqrt(a00)
    l10 = a[..., 1, 0] / l00
    l20 = a[..., 2, 0] / l00
    d11 = jnp.maximum(a[..., 1, 1] - l10 * l10, eps)
    l11 = jnp.sqrt(d11)
    l21 = (a[..., 2, 1] - l20 * l10) / l11
    d22 = jnp.maximum(a[..., 2, 2] - l20 * l20 - l21 * l21, eps)
    l22 = jnp.sqrt(d22)
    z = jnp.zeros_like(l00)
    return jnp.stack([
        jnp.stack([l00, z, z], axis=-1),
        jnp.stack([l10, l11, z], axis=-1),
        jnp.stack([l20, l21, l22], axis=-1),
    ], axis=-2)


def _inv_lower3(l):
    """Inverse of (..., 3, 3) lower-triangular blocks, closed form."""
    i00 = 1.0 / l[..., 0, 0]
    i11 = 1.0 / l[..., 1, 1]
    i22 = 1.0 / l[..., 2, 2]
    i10 = -l[..., 1, 0] * i00 * i11
    i20 = (l[..., 1, 0] * l[..., 2, 1] - l[..., 2, 0] * l[..., 1, 1]) * (
        i00 * i11 * i22)
    i21 = -l[..., 2, 1] * i11 * i22
    z = jnp.zeros_like(i00)
    return jnp.stack([
        jnp.stack([i00, z, z], axis=-1),
        jnp.stack([i10, i11, z], axis=-1),
        jnp.stack([i20, i21, i22], axis=-1),
    ], axis=-2)


@highest_matmul_precision
def banded_cholesky(hb):
    """Factor block-banded SPD H into lower-banded L (same storage).

    Args:
        hb: ``(D, T1, 3, 3)`` upper-band storage, ``hb[d, i] = H[i, i+d]``.

    Returns:
        ``lb``: ``(D, T1, 3, 3)`` lower-band storage,
        ``lb[d, i] = L[i+d, i]`` (block column i of the factor).
    """
    d1, t1 = hb.shape[0], hb.shape[1]
    band = d1 - 1
    # hb_t[i, d] = H[i+d, i] = hb[d, i]^T: the lower column blocks.
    hb_cols = jnp.swapaxes(jnp.swapaxes(hb, 0, 1), -1, -2)  # (T1, D, 3, 3)

    a_idx = jnp.arange(band)
    d_idx = jnp.arange(d1)
    # gather index d + a + 1 (clipped) and its validity mask
    g_idx = jnp.clip(d_idx[:, None] + a_idx[None, :] + 1, 0, band)
    g_ok = ((d_idx[:, None] + a_idx[None, :] + 1) <= band).astype(
        hb.dtype)[..., None, None]

    def step(carry, h_col):
        # carry: C (band, D, 3, 3) - block columns i-1, i-2, ... of L.
        c = carry
        # cd[a] = L[i, i-1-a] = C[a, a+1]
        cd = c[a_idx, a_idx + 1]  # (band, 3, 3)
        s = h_col[0] - jnp.einsum("aij,akj->ik", cd, cd)
        l00 = _chol3(s)
        l00_inv_t = jnp.swapaxes(_inv_lower3(l00), -1, -2)

        # g[d, a] = L[i+d, i-1-a] = C[a, d+a+1] (0 when out of band)
        g = c[a_idx[None, :], g_idx] * g_ok  # (D, band, 3, 3)
        m = h_col - jnp.einsum("daij,akj->dik", g, cd)
        col = m @ l00_inv_t  # (D, 3, 3): col[d] = L[i+d, i]
        col = col.at[0].set(l00)
        new_c = jnp.concatenate([col[None], c[:-1]], axis=0)
        return new_c, col

    c0 = jnp.zeros((band, d1, 3, 3), hb.dtype)
    _, cols = jax.lax.scan(step, c0, hb_cols)
    return jnp.swapaxes(cols, 0, 1)  # (D, T1, 3, 3) = lb[d, i]


@highest_matmul_precision
def banded_chol_solve(lb, b):
    """Solve H x = b given the banded factor from :func:`banded_cholesky`.

    Forward substitution L z = b, then backward L^T x = z; each is a
    ``lax.scan`` with a ``band``-deep sliding window.
    """
    d1, t1 = lb.shape[0], lb.shape[1]
    band = d1 - 1
    l00_inv = _inv_lower3(lb[0])  # (T1, 3, 3)

    # lsh[i, d] = L[i, i-d] = lb[d, i-d] for d in [1, band]
    d_idx = jnp.arange(1, d1)
    i_idx = jnp.arange(t1)
    src = jnp.clip(i_idx[:, None] - d_idx[None, :], 0, t1 - 1)
    ok = (i_idx[:, None] - d_idx[None, :] >= 0).astype(
        lb.dtype)[..., None, None]
    lsh = lb[d_idx[None, :], src] * ok  # (T1, band, 3, 3)

    def fwd(win, inputs):
        # win[a] = z[i-1-a]
        lrow, li, bi = inputs
        zi = jnp.einsum("ij,j->i", li,
                        bi - jnp.einsum("aij,aj->i", lrow, win))
        return jnp.concatenate([zi[None], win[:-1]], axis=0), zi

    _, z = jax.lax.scan(fwd, jnp.zeros((band, 3), b.dtype),
                        (lsh, l00_inv, b))

    # Backward: x[i] = inv(L00_i^T) (z[i] - sum_d lb[d, i]^T x[i+d]).
    lb_t = jnp.swapaxes(jnp.swapaxes(lb, 0, 1), -1, -2)  # (T1, D, 3, 3)
    l00_inv_t = jnp.swapaxes(l00_inv, -1, -2)

    def bwd(win, inputs):
        # win[a] = x[i+1+a]
        lcol, lit, zi = inputs
        xi = jnp.einsum("ij,j->i", lit,
                        zi - jnp.einsum("aij,aj->i", lcol[1:], win))
        return jnp.concatenate([xi[None], win[:-1]], axis=0), xi

    _, x_rev = jax.lax.scan(bwd, jnp.zeros((band, 3), b.dtype),
                            (lb_t[::-1], l00_inv_t[::-1], z[::-1]))
    return x_rev[::-1]


def banded_solve_direct(hb, b):
    """One-shot H x = b via banded Cholesky (factor + two substitutions)."""
    return banded_chol_solve(banded_cholesky(hb), b.reshape(-1, 3)).reshape(
        b.shape)


@highest_matmul_precision
def banded_solve_direct_flat(h_flat, b_flat, band: int):
    """Flat-layout twin of :func:`banded_solve_direct`.

    Same factorization (identical 3x3 block recurrences), but H streams
    through the scans as ``(T1, (band+1)*9)`` scalar rows and the factor
    is emitted the same way - NO tensor with a trailing ``(3, 3)`` pair
    ever materializes at trajectory length (the ``(D, T1, 3, 3)``
    layouts of :func:`banded_cholesky` tile-pad 57-128x and OOM beyond
    ~150k poses; see ``slamsim/slam/large.py::assemble_banded_flat``).
    The per-step block algebra operates on ``(D, 3, 3)`` slices of ONE
    row - small, carried values that never hit HBM layouts.

    Two scans instead of three: the forward substitution ``L z = b``
    consumes columns in emission order, so it rides inside the
    factorization scan (the carry window C already holds exactly the
    columns it needs); only the backward sweep needs a second (reversed)
    scan over the emitted factor rows.

    Args:
        h_flat: ``((band+1)*9, T1)`` flat banded storage,
            ``h_flat[d*9 + 3a + b, t] = H[t, t+d][a, b]``.
        b_flat: ``(3, T1)`` phase-major right-hand side.

    Returns:
        ``(T1, 3)`` solution (same orientation as the band-layout
        solvers' output).
    """
    d1 = band + 1
    t1 = h_flat.shape[1]
    a_idx = jnp.arange(band)
    d_idx = jnp.arange(d1)
    g_idx = jnp.clip(d_idx[:, None] + a_idx[None, :] + 1, 0, band)
    g_ok = ((d_idx[:, None] + a_idx[None, :] + 1) <= band).astype(
        h_flat.dtype)[..., None, None]

    ht = h_flat.T  # (T1, D*9) scalar rows - the ONLY large operand
    bt = b_flat.T  # (T1, 3)

    def fwd_step(carry, inputs):
        c, zwin = carry  # C: (band, D, 3, 3) columns i-1-a; zwin: (band, 3)
        h_row, b_i = inputs
        # h_col[d] = H[i+d, i] = (flat block d at column i)^T.
        h_col = jnp.swapaxes(h_row.reshape(d1, 3, 3), -1, -2)
        cd = c[a_idx, a_idx + 1]  # L[i, i-1-a]
        s = h_col[0] - jnp.einsum("aij,akj->ik", cd, cd)
        l00 = _chol3(s)
        l00_inv = _inv_lower3(l00)
        g = c[a_idx[None, :], g_idx] * g_ok
        m = h_col - jnp.einsum("daij,akj->dik", g, cd)
        col = m @ jnp.swapaxes(l00_inv, -1, -2)
        col = col.at[0].set(l00)
        # Forward substitution folded in: z_i = L00^-1 (b_i - cd . z_win).
        z_i = jnp.einsum("ij,j->i", l00_inv,
                         b_i - jnp.einsum("aij,aj->i", cd, zwin))
        new_c = jnp.concatenate([col[None], c[:-1]], axis=0)
        new_z = jnp.concatenate([z_i[None], zwin[:-1]], axis=0)
        return (new_c, new_z), (col.reshape(d1 * 9), z_i)

    c0 = jnp.zeros((band, d1, 3, 3), h_flat.dtype)
    z0 = jnp.zeros((band, 3), h_flat.dtype)
    _, (lrows, z) = jax.lax.scan(fwd_step, (c0, z0), (ht, bt))

    def bwd_step(xwin, inputs):
        # xwin[a] = x[i+1+a]
        l_row, z_i = inputs
        col = l_row.reshape(d1, 3, 3)
        xi = jnp.einsum("ji,j->i", _inv_lower3(col[0]),
                        z_i - jnp.einsum("aji,aj->i", col[1:],
                                         xwin[:band]))
        return jnp.concatenate([xi[None], xwin[:-1]], axis=0), xi

    _, x_rev = jax.lax.scan(bwd_step, jnp.zeros((band, 3), h_flat.dtype),
                            (lrows[::-1], z[::-1]))
    return x_rev[::-1]
