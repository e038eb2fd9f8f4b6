"""Block cyclic reduction: the latency-optimal banded solver.

:mod:`slamsim.slam.tridiag`'s block Thomas elimination is made of dense
matmul-shaped blocks but is SEQUENTIAL: 2 * T1/S scan steps, each with a
fixed per-iteration cost whatever its content.  Cyclic reduction (CR)
restructures the same super-block tridiagonal solve into ``log2(N)``
LEVELS, each a fully BATCHED Schur elimination of the odd-indexed blocks
(vmapped Cholesky + matmuls over all remaining blocks at once):

  level l:  eliminate x_odd:  x_o = A_o^{-1} (b_o - U_left^T x_le -
            U_right x_ri)  ->  tridiagonal system over the evens with
            A'_e = A_e - U_l^T A_o^{-1} U_l - U_r A_o^{-1} U_r^T (an SPD
            Schur complement), recurse until one block remains.

Sequential depth drops from O(N) to O(log N) with ~2x the flops - the
right trade where the matrix units sit idle in the Thomas scan.  The shapes
halve each level, so the level loop is a plain unrolled Python loop
(static shapes; no lax.scan and none of its per-iteration overhead).

At large T1, CR's power-of-two block padding and extra flops outgrow its
depth advantage and the Thomas scan wins; where the crossover lies on the
GPU is not measured yet (PERF.md).  Pick ``"cr"`` for latency-sensitive
medium trajectories, ``"tridiag"`` at very large T1.

Same numerical guards as the Thomas path: symmetric Jacobi prescaling
and symmetrized Schur complements (see tridiag.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slamsim.core.precision import highest_matmul_precision
from slamsim.slam.tridiag import (_flat_prescale, _flat_to_tridiag,
                                  band_to_tridiag, flat_rows_to_super,
                                  jacobi_prescale, pad_band, pad_flat,
                                  super_rows_to_flat)


def _cho_solve_batch(d, y):
    """Batched SPD solve via Cholesky: d (N, M, M), y (N, M, K|M)."""
    chol = jnp.linalg.cholesky(d)
    return chol, jax.scipy.linalg.cho_solve((chol, True), y)


def block_cr_solve(diag, upper, b):
    """Solve the symmetric block-tridiagonal system by cyclic reduction.

    System: ``diag[k] x_k + upper[k] x_{k+1} + upper[k-1]^T x_{k-1} =
    b_k`` - the same convention as
    :func:`slamsim.slam.tridiag.block_thomas_solve`.

    Args:
        diag: ``(N, M, M)`` with N a power of two (pad with identity
            blocks); upper: ``(N-1, M, M)``; b: ``(N, M)``.

    Returns:
        ``(N, M)`` solution.
    """
    n, m = diag.shape[0], diag.shape[1]
    if n & (n - 1):
        raise ValueError(f"N={n} must be a power of two (pad first)")
    # u[k] = U_k, with U_{n-1} = 0 (no coupling past the end).
    u = jnp.concatenate([upper, jnp.zeros((1, m, m), diag.dtype)], axis=0)

    with jax.default_matmul_precision("highest"):
        # ---- forward: halve until one block remains --------------------
        stack = []  # per level: (d_odd_chol, u_even, u_odd, b_odd)
        d, bb = diag, b
        while d.shape[0] > 1:
            half = d.shape[0] // 2
            d_e, d_o = d[0::2], d[1::2]
            u_e, u_o = u[0::2], u[1::2]  # U_{2p}, U_{2p+1} (last is 0)
            b_e, b_o = bb[0::2], bb[1::2]

            # Per odd block: A_o^{-1} applied to [U_odd | U_even^T | b].
            rhs = jnp.concatenate(
                [u_o, jnp.swapaxes(u_e, -1, -2), b_o[..., None]], axis=-1)
            chol_o, sol = _cho_solve_batch(d_o, rhs)
            w1 = sol[..., :m]           # A_o^{-1} U_odd
            w2 = sol[..., m:2 * m]      # A_o^{-1} U_even^T
            y_o = sol[..., 2 * m]       # A_o^{-1} b_odd

            # Even update.  Left neighbor of even 2p is odd 2p-1 = odd
            # block p-1; shift the odd-block terms down by one (p=0 has
            # no left neighbor).
            left_t = jnp.einsum("nij,nik->njk", u_o, w1)   # U_o^T Ao^-1 U_o
            left_b = jnp.einsum("nij,ni->nj", u_o, y_o)    # U_o^T y_o
            zpad_t = jnp.zeros((1, m, m), d.dtype)
            zpad_b = jnp.zeros((1, m), d.dtype)
            left_t = jnp.concatenate([zpad_t, left_t[:-1]], axis=0)
            left_b = jnp.concatenate([zpad_b, left_b[:-1]], axis=0)

            right_t = jnp.einsum("nij,njk->nik", u_e, w2)  # U_e Ao^-1 U_e^T
            right_b = jnp.einsum("nij,nj->ni", u_e, y_o)

            d_new = d_e - left_t - right_t
            d_new = 0.5 * (d_new + jnp.swapaxes(d_new, -1, -2))
            b_new = b_e - left_b - right_b
            # Coupling even 2p -> even 2p+2: -U_{2p} A_o^{-1} U_{2p+1};
            # the p = half-1 entry uses U_{n-1} = 0, giving the required
            # zero end coupling.
            u_new = -jnp.einsum("nij,njk->nik", u_e, w1)

            stack.append((chol_o, u_e, u_o, b_o))
            d, u, bb = d_new, u_new, b_new

        # ---- root solve -------------------------------------------------
        chol0, x = _cho_solve_batch(d, bb[..., None])
        x = x[..., 0]  # (1, M)

        # ---- back substitution ------------------------------------------
        for chol_o, u_e, u_o, b_o in reversed(stack):
            # x_odd[p] = A_o^{-1}(b_o - U_{2p}^T x_e[p] - U_{2p+1} x_e[p+1])
            x_right = jnp.concatenate(
                [x[1:], jnp.zeros((1, m), x.dtype)], axis=0)
            rhs = (b_o - jnp.einsum("nij,ni->nj", u_e, x)
                   - jnp.einsum("nij,nj->ni", u_o, x_right))
            x_o = jax.scipy.linalg.cho_solve((chol_o, True),
                                             rhs[..., None])[..., 0]
            nn = x.shape[0] * 2
            out = jnp.zeros((nn, m), x.dtype)
            x = out.at[0::2].set(x).at[1::2].set(x_o)

    return x


def _pick_super_size(band: int, t1: int) -> int:
    """CR super-block size heuristic (shared by both layouts).

    Pick S in [band, 2*band] minimizing power-of-two padding, but
    prefer a dense block dim 3S <= 128 when possible: a block that
    straddles 128-wide tiles has measured far slower than more padded
    rows in smaller blocks - layout beats row count.
    """
    base = max(band, 1)

    def waste(s_try):
        n_try = -(-t1 // s_try)
        n2 = 1 << max(n_try - 1, 0).bit_length()
        return n2 * s_try - t1

    cands = list(range(base, 2 * base + 1))
    tile_friendly = [s for s in cands if 3 * s <= 128]
    return min(tile_friendly or cands, key=waste)


def _pad_super_pow2(diag, upper, b_sup):
    """Pad the super-block count to a power of two with decoupled
    identity blocks directly in dense ``(N, 3S, 3S)`` space (their
    solution is exactly 0 for the zero RHS padding)."""
    n, s3 = diag.shape[0], diag.shape[1]
    n2 = 1 << max(n - 1, 0).bit_length()
    if n2 == n:
        return diag, upper, b_sup
    eye_tail = jnp.tile(jnp.eye(s3, dtype=diag.dtype)[None],
                        (n2 - n, 1, 1))
    diag = jnp.concatenate([diag, eye_tail], axis=0)
    upper = jnp.concatenate(
        [upper, jnp.zeros((n2 - n, s3, s3), diag.dtype)], axis=0)
    b_sup = jnp.concatenate(
        [b_sup, jnp.zeros((n2 - n, s3), b_sup.dtype)], axis=0)
    return diag, upper, b_sup


def banded_solve_cr_flat(h_flat, b_flat, band: int,
                         super_size: int | None = None):
    """Flat-layout twin of :func:`banded_solve_cr`.

    Same math (pad + Jacobi prescale + super-block cyclic reduction),
    but the band-to-super-block densification runs on the flat
    ``((band+1)*9, T1)`` entry layout (:func:`slamsim.slam.tridiag.\
_flat_to_tridiag`), so no intermediate carries trailing (3, 3) dims
    whose tile-padded layouts OOM beyond ~150k poses.  The power-of-two
    super-block padding CR needs is applied in dense ``(N, 3S, 3S)``
    space AFTER densification (identity diagonal blocks decouple
    exactly), so the padded region never touches the flat pipeline.
    """
    t1 = h_flat.shape[1]
    if super_size is None:
        super_size = _pick_super_size(band, t1)
    h_flat, b_flat = pad_flat(h_flat, b_flat, super_size)

    with jax.default_matmul_precision("highest"):
        h_s, b_s, s = _flat_prescale(h_flat, b_flat, band)
        diag, upper = _flat_to_tridiag(h_s, band, super_size)
        b_sup = flat_rows_to_super(b_s, super_size)
        # upper must have N entries (last = 0) before pow2 padding so
        # the padded blocks stay decoupled.
        s3 = diag.shape[1]
        upper_n = jnp.concatenate(
            [upper, jnp.zeros((1, s3, s3), diag.dtype)], axis=0)
        diag, upper_n, b_sup = _pad_super_pow2(diag, upper_n, b_sup)
        x = block_cr_solve(diag, upper_n[:-1], b_sup)
        x3 = super_rows_to_flat(x[:b_s.shape[1] // super_size],
                                super_size) * s
    return x3.T[:t1]


@highest_matmul_precision
def banded_solve_cr(h_band, b, super_size: int | None = None):
    """One-shot ``H x = b`` via super-block retiling + cyclic reduction.

    Drop-in alternative to
    :func:`slamsim.slam.tridiag.banded_solve_tridiag` with O(log N)
    sequential depth; pads the super-block count to a power of two with
    decoupled identity blocks.
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    band = d1 - 1
    if super_size is None:
        super_size = _pick_super_size(band, t1)
    h_band, b = pad_band(h_band, b, super_size)
    n = h_band.shape[1] // super_size
    n_pow2 = 1 << max(n - 1, 0).bit_length()  # next power of two
    if n_pow2 > n:
        h_band, b = pad_band(h_band, b, n_pow2 * super_size)
    t_pad = h_band.shape[1]
    n = t_pad // super_size

    h_scaled, b_scaled, s = jacobi_prescale(h_band, b)
    diag, upper = band_to_tridiag(h_scaled, super_size)
    x = block_cr_solve(diag, upper, b_scaled.reshape(n, 3 * super_size))
    return (x.reshape(t_pad, 3) * s)[:t1]
