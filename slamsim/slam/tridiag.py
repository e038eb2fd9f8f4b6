"""Super-block tridiagonal solver: the dense-block path for banded H.

The banded solvers in ``large.py``/``cholesky.py`` operate on 3x3 blocks -
correct, but at 10k poses their inner loops are thousands of tiny
elementwise ops (CG) or a 10k-step scan (Cholesky), both latency-bound.
This
module re-tiles the same block-banded matrix into a block-TRIDIAGONAL
system of dense ``S``-block super-blocks (3S x 3S scalars, S >= band): the
entire band fits inside the diagonal + one coupling block, so a block-
Thomas elimination needs only ``T1/S`` sequential steps, each a dense
3S x 3S factor/solve that XLA maps onto dense matrix kernels.

For band 40 at 10k poses: 250 scan steps of 120x120 algebra versus 10,000
steps of 3x3 algebra - the sequential depth drops 40x and every op is a
dense block product.  This is the production solver for BASELINE config 5.

Two pipelines share the Thomas core (:func:`block_thomas_solve`):

* :func:`banded_solve_tridiag` - the original ``(D, T1, 3, 3)`` block
  layout (kept for the CR solver's re-tiling and as the test oracle).
* :func:`banded_solve_tridiag_flat` - the PRODUCTION path: operates on
  the flat ``((band+1)*9, T1)`` entry layout end-to-end, so no
  intermediate carries small trailing dims.  XLA may materialize such
  tensors with the tiny dims minor and pad them to a tiled layout -
  blowups of 14-128x that once exhausted device memory past ~150k
  poses.  The flat path scales to 1M poses.
"""

from __future__ import annotations

import typing

import jax
import jax.numpy as jnp

from slamsim.core.precision import highest_matmul_precision


def band_to_tridiag(h_band, super_size: int):
    """Re-tile block-banded storage into super-block tridiagonal form.

    Args:
        h_band: ``(D, T1, 3, 3)`` upper-band storage (``D - 1 <= S``).
        super_size: S, number of 3x3 blocks per super-block; T1 must be a
            multiple of S (pad the trajectory if needed).

    Returns:
        ``(diag (N, 3S, 3S), upper (N-1, 3S, 3S))`` where N = T1 // S;
        ``upper[k] = H[super k, super k+1]``.
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    band = d1 - 1
    if band > super_size:
        raise ValueError(f"band {band} exceeds super block size "
                         f"{super_size}")
    if t1 % super_size:
        raise ValueError(f"T1 {t1} not a multiple of {super_size}")
    n = t1 // super_size
    s3 = 3 * super_size

    # Dense per-pair scalar matrix entries from the band:
    # H[i, i+d] = h_band[d, i].  Build a (T1, D, 3, 3) view then scatter
    # into (N, S, S+S, 3, 3) local coordinates: row r in super k is global
    # i = k*S + r; column i + d lands in super k at c = r + d (c < S ->
    # diag block; c >= S -> upper block at c - S).
    r = jnp.arange(super_size)
    d = jnp.arange(d1)
    # cols[r, d] = r + d in [0, S + band)
    cols = r[:, None] + d[None, :]

    hb = jnp.swapaxes(h_band, 0, 1)  # (T1, D, 3, 3)
    hb = hb.reshape(n, super_size, d1, 3, 3)

    # wide[k, r, c] = H[k*S + r, k*S + c] for c in [0, S + band)
    wide = jnp.zeros((n, super_size, super_size + band, 3, 3),
                     h_band.dtype)
    wide = wide.at[:, r[:, None], cols].set(hb)

    diag_u = wide[:, :, :super_size]  # upper triangle of diagonal blocks
    upper = wide[:, :, super_size:]  # coupling into the next super block

    # Densify: diag = diag_u + strict-lower from transpose.
    def to_dense(x):  # (n, S, C, 3, 3) -> (n, 3S, 3C)
        nn, ss, cc = x.shape[0], x.shape[1], x.shape[2]
        return x.transpose(0, 1, 3, 2, 4).reshape(nn, 3 * ss, 3 * cc)

    # Mirror the strictly-upper BLOCKS (the (r, r) blocks are already
    # full 3x3 matrices; mirroring at scalar level would double their
    # lower scalars).
    strict_mask = (jnp.arange(super_size)[:, None]
                   < jnp.arange(super_size)[None, :])
    diag_d = to_dense(diag_u)
    mirror = to_dense(diag_u * strict_mask[None, :, :, None, None])
    diag = diag_d + mirror.swapaxes(-1, -2)

    up_d = to_dense(upper)  # (n, 3S, 3*band) -> embed into (n, 3S, 3S)
    up = jnp.zeros((n, s3, s3), h_band.dtype)
    up = up.at[:, :, :up_d.shape[2]].set(up_d)
    return diag, up[:-1]


class ThomasFactor(typing.NamedTuple):
    """Reusable block-Thomas factorization (see :func:`block_thomas_factor`).

    ``invs[k] = S_k^{-1}`` (Schur-complement inverses), ``ws[k] =
    S_{k-1}^{-1} U_{k-1}`` (the forward-substitution multipliers), and
    ``up`` the zero-extended upper coupling blocks — everything the
    substitution passes need, nothing that depends on the rhs.
    """

    invs: jax.Array  # (N, M, M)
    ws: jax.Array  # (N, M, M)
    up: jax.Array  # (N, M, M)


def block_thomas_factor(diag, upper) -> ThomasFactor:
    """Factor the symmetric block-tridiagonal system once.

    The forward elimination of :func:`block_thomas_solve` splits into a
    rhs-independent factorization (this function: the Cholesky/Schur
    recursion, O(M^3) per block) and a cheap rhs substitution
    (:func:`block_thomas_substitute`, O(M^2) matvecs per block).  When
    the system matrix is CONSTANT across Gauss-Newton iterations — the
    exact-Jacobian + frozen-Omega graph formulation, where only the rhs
    changes (see :func:`slamsim.slam.large.graph_solve_banded`
    ``reuse_factorization``) — factoring once turns every GN iteration
    after the first into a substitution.

    Returns a :class:`ThomasFactor`; ``block_thomas_substitute(factor,
    b)`` is bit-identical to ``block_thomas_solve(diag, upper, b)``
    (same ops in the same order, just staged).
    """
    n, m = diag.shape[0], diag.shape[1]
    up = jnp.concatenate([upper, jnp.zeros((1, m, m), diag.dtype)], axis=0)
    eye = jnp.eye(m, dtype=diag.dtype)

    with jax.default_matmul_precision("highest"):
        def fwd(carry, inputs):
            inv_prev, u_prev = carry
            a_k, u_k = inputs
            w = inv_prev @ u_prev  # S_{k-1}^{-1} U_{k-1}
            s_k = a_k - u_prev.T @ w
            s_k = 0.5 * (s_k + s_k.T)
            chol_k = jnp.linalg.cholesky(s_k)
            li = jax.lax.linalg.triangular_solve(
                chol_k, eye, left_side=True, lower=True)
            inv_k = li.T @ li
            return (inv_k, u_k), (inv_k, w)

        init = (eye, jnp.zeros((m, m), diag.dtype))
        _, (invs, ws) = jax.lax.scan(fwd, init, (diag, up))
    return ThomasFactor(invs=invs, ws=ws, up=up)


def block_thomas_substitute(factor: ThomasFactor, b):
    """Solve with a precomputed :class:`ThomasFactor` (two O(M^2) scans).

    Bit-identical to :func:`block_thomas_solve` on the same system:
    the forward pass replays ``y_k = b_k - y_{k-1} W_k`` with the
    recorded multipliers, the backward pass is unchanged.
    """
    invs, ws, up = factor
    n, m = invs.shape[0], invs.shape[1]
    squeeze = b.ndim == 2
    b_row = b[:, None, :] if squeeze else b  # (n, K, m)
    n_rhs = b_row.shape[1]
    with jax.default_matmul_precision("highest"):
        def fwd(y_prev, inputs):
            w_k, b_k = inputs
            y_k = b_k - y_prev @ w_k
            return y_k, y_k

        _, ys = jax.lax.scan(
            fwd, jnp.zeros((n_rhs, m), invs.dtype), (ws, b_row))

        def bwd(x_next, inputs):
            inv_k, y_k, u_k = inputs
            x_k = (y_k - x_next @ u_k.T) @ inv_k
            return x_k, x_k

        _, xs_rev = jax.lax.scan(
            bwd, jnp.zeros((n_rhs, m), invs.dtype),
            (invs[::-1], ys[::-1], up[::-1]))
        return xs_rev[::-1, 0, :] if squeeze else xs_rev[::-1]


class PartitionedThomasFactor(typing.NamedTuple):
    """Single-chip substructured (SPIKE-style) block-Thomas factor.

    The sequential depth of :func:`block_thomas_substitute` is N scan
    steps, each of which costs latency rather than FLOPs.  Partitioning the
    chain into ``C`` chunks turns both the factorization and every
    substitution into BATCHED scans of depth ``N/C`` (the same math as
    the device-sharded :mod:`slamsim.parallel.tridiag_shard`, with the
    mesh axis replaced by a batch axis) plus a tiny C-block reduced
    interface system.  HBM footprint matches the sequential factor: the
    per-chunk factors store the same N blocks, and the three corner
    blocks of each chunk inverse ride carry-only matmul chains instead
    of stored T^-1 columns.
    """

    chunk: ThomasFactor  # per-chunk interior factors, TIME-major
    #: (m-1, C, M, M) fields; m = chunk.invs.shape[0] + 1 blocks/chunk
    red: ThomasFactor  # reduced interface factor (C blocks)
    b_cpl: jax.Array  # (C, M, M) last-interior <-> interface coupling
    c_cpl: jax.Array  # (C, M, M) interface <-> next-chunk coupling


def _batched_inv_spd(a):
    """Batched SPD inverse via Cholesky (same op chain as the Thomas
    factor's per-step inverse)."""
    m = a.shape[-1]
    eye = jnp.eye(m, dtype=a.dtype)
    chol = jnp.linalg.cholesky(0.5 * (a + jnp.swapaxes(a, -1, -2)))
    li = jax.lax.linalg.triangular_solve(
        chol, jnp.broadcast_to(eye, a.shape), left_side=True, lower=True)
    return jnp.swapaxes(li, -1, -2) @ li


def _chol3(d):
    """Closed-form batched 3x3 lower Cholesky.

    No ``lax.linalg``: a ``cholesky`` lowering may run one batch element
    at a time inside a scan body, while elementwise chains like this one
    vectorize.
    Same arithmetic as the textbook recursion, so non-PD inputs yield
    NaN exactly where ``jnp.linalg.cholesky`` would.
    """
    l11 = jnp.sqrt(d[..., 0, 0])
    l21 = d[..., 1, 0] / l11
    l31 = d[..., 2, 0] / l11
    l22 = jnp.sqrt(d[..., 1, 1] - l21 * l21)
    l32 = (d[..., 2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(d[..., 2, 2] - l31 * l31 - l32 * l32)
    z = jnp.zeros_like(l11)
    return jnp.stack([
        jnp.stack([l11, z, z], axis=-1),
        jnp.stack([l21, l22, z], axis=-1),
        jnp.stack([l31, l32, l33], axis=-1)], axis=-2)


def _inv_lower3(lo):
    """Closed-form batched inverse of a 3x3 lower-triangular factor."""
    l11, l21, l22 = lo[..., 0, 0], lo[..., 1, 0], lo[..., 1, 1]
    l31, l32, l33 = lo[..., 2, 0], lo[..., 2, 1], lo[..., 2, 2]
    m11, m22, m33 = 1.0 / l11, 1.0 / l22, 1.0 / l33
    m21 = -l21 * m11 * m22
    m32 = -l32 * m22 * m33
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    z = jnp.zeros_like(m11)
    return jnp.stack([
        jnp.stack([m11, z, z], axis=-1),
        jnp.stack([m21, m22, z], axis=-1),
        jnp.stack([m31, m32, m33], axis=-1)], axis=-2)


def _chol_blocked(a, blk: int = 3):
    """Batched blocked lower Cholesky from closed-form 3x3 factors +
    ``dot_general`` only (right-looking, shrinking trailing update) —
    every op vectorizes over the leading batch axes inside a scan."""
    m = a.shape[-1]
    nb = m // blk
    batch = a.shape[:-2]
    cols = []
    w = a
    for k in range(nb):
        lkk = _chol3(w[..., :blk, :blk])
        if k + 1 < nb:
            li = _inv_lower3(lkk)
            p = w[..., blk:, :blk]
            x = jnp.einsum("...ij,...kj->...ik", p, li)  # P @ L_kk^-T
            w = w[..., blk:, blk:] - jnp.einsum("...ik,...jk->...ij",
                                                x, x)
            col = jnp.concatenate([lkk, x], axis=-2)
        else:
            col = lkk
        if k:
            col = jnp.concatenate(
                [jnp.zeros((*batch, k * blk, blk), a.dtype), col],
                axis=-2)
        cols.append(col)
    return jnp.concatenate(cols, axis=-1)


def _inv_lower_blocked(lo, blk: int = 3):
    """Batched inverse of a blocked lower-triangular factor (forward
    substitution by ``blk``-row panels; one panel dot per step)."""
    m = lo.shape[-1]
    nb = m // blk
    eye = jnp.eye(m, dtype=lo.dtype)
    acc = None
    for k in range(nb):
        s = k * blk
        likk = _inv_lower3(lo[..., s:s + blk, s:s + blk])
        rhs = jnp.broadcast_to(eye[s:s + blk],
                               (*lo.shape[:-2], blk, m))
        if k:
            rhs = rhs - lo[..., s:s + blk, :s] @ acc
        rows = likk @ rhs
        acc = rows if k == 0 else jnp.concatenate([acc, rows], axis=-2)
    return acc


def _batched_inv_spd_blocked(a, blk: int = 3):
    """SPD inverse that stays VECTORIZED over the batch inside scans.

    ``Li^T Li`` with ``Li`` from the blocked closed-form Cholesky; same
    Cholesky->triangular-inverse->Gram chain as :func:`_batched_inv_spd`
    (agreement to roundoff), but built only from elementwise chains and
    ``dot_general`` — ops that batch flat, unlike ``cholesky`` /
    ``triangular_solve`` lowerings that may run one batch element at a
    time inside a scan body.
    """
    li = _inv_lower_blocked(
        _chol_blocked(0.5 * (a + jnp.swapaxes(a, -1, -2)), blk), blk)
    return jnp.swapaxes(li, -1, -2) @ li


def block_thomas_factor_partitioned(diag, upper,
                                    n_parts: int,
                                    inv_impl: str = "lax"
                                    ) -> PartitionedThomasFactor:
    """Factor the N-block chain as ``n_parts`` independent chunks.

    Requires ``N % n_parts == 0`` and ``m = N // n_parts >= 2``.
    Reduced-system derivation (chunk interiors ``u_c``, interfaces
    ``s_c`` = last block of each chunk; ``B_c`` couples interior m-2 to
    ``s_c``, ``C_c`` couples ``s_c`` to chunk c+1's interior 0):

      Ahat_c    = A_ic - B_c^T Dm_c B_c - C_c D0_{c+1} C_c^T
      Uhat_c    = -C_c G_{c+1} B_{c+1}
      bhat_c    = f_c - B_c^T r_c[m-2] - C_c r_{c+1}[0]

    with ``Dm = [T^-1]_{m-2,m-2}`` (the chunk factor's last Schur
    inverse), ``D0 = [T^-1]_{0,0}`` (a reverse Schur recursion, carry
    only), ``G = [T^-1]_{0,m-2}`` (the backward multiplier chain
    ``x_j = -inv_j U_j x_{j+1}``, carry only), and ``r = T^-1 g``.

    ``inv_impl`` selects the per-step SPD inverse: ``"lax"`` (default)
    uses ``jnp.linalg.cholesky`` + ``triangular_solve``; ``"blocked"`` is
    :func:`_batched_inv_spd_blocked` — closed-form 3x3 Cholesky chains +
    panel ``dot_general``s only.  Before this code ran on the GPU,
    "blocked" measured slower than "lax" and its f32 solution error ~30x
    larger (closed-form division chains); on the GPU it is not measured
    yet.  A Newton-Schulz matmul-only inverse was also tried and
    rejected: the warm-start residual ``||I - S_k X_{k-1}||`` measures
    2.6 mean / 9 max on real prescaled chains (S = band packs a full
    bandwidth per super-block, so consecutive Schur complements are NOT
    close) - the iteration diverges.
    """
    n, m_blk = diag.shape[0], diag.shape[1]
    c = n_parts
    if n % c:
        raise ValueError(f"N={n} not a multiple of n_parts={c}")
    m = n // c
    if m < 2:
        raise ValueError(f"n_parts={c} leaves m={m} < 2 blocks/chunk")
    up = jnp.concatenate([upper, jnp.zeros((1, m_blk, m_blk),
                                           diag.dtype)], axis=0)
    diag_r = diag.reshape(c, m, m_blk, m_blk)
    up_r = up.reshape(c, m, m_blk, m_blk)
    # TIME-major (m-1, C, M, M) interiors: every scan below (factor,
    # reverse Schur, corner chain, the substitutions) iterates the
    # within-chunk axis, so one transpose here replaces per-scan
    # flipped/transposed copies that blew HBM at 1M poses.
    a_int = jnp.swapaxes(diag_r[:, :m - 1], 0, 1)
    a_if = diag_r[:, m - 1]  # (C, M, M) interface diagonals
    u_int = jnp.swapaxes(up_r[:, :max(m - 2, 0)], 0, 1)
    b_cpl = up_r[:, m - 2]  # (C, M, M)
    c_cpl = up_r[:, m - 1]  # (C, M, M); zero for the last chunk
    eye = jnp.eye(m_blk, dtype=diag.dtype)
    if inv_impl == "blocked" and m_blk % 3 == 0:
        inv_fn = _batched_inv_spd_blocked
    else:
        inv_fn = _batched_inv_spd

    with jax.default_matmul_precision("highest"):
        # Batched chunk factor (block_thomas_factor's recursion with a
        # C-wide batch axis), time-major in and out.
        up_x = jnp.concatenate(
            [u_int, jnp.zeros((1, c, m_blk, m_blk), diag.dtype)], axis=0)

        def fwd(carry, inputs):
            inv_prev, u_prev = carry
            a_k, u_k = inputs
            w = inv_prev @ u_prev
            s_k = a_k - jnp.swapaxes(u_prev, -1, -2) @ w
            inv_k = inv_fn(s_k)
            return (inv_k, u_k), (inv_k, w)

        init = (jnp.broadcast_to(eye, (c, m_blk, m_blk)),
                jnp.zeros((c, m_blk, m_blk), diag.dtype))
        _, (invs, ws) = jax.lax.scan(fwd, init, (a_int, up_x))
        chunk = ThomasFactor(invs=invs, ws=ws, up=up_x)
        dm = invs[-1]  # [T^-1]_{m-2,m-2}

        # D0 = [T^-1]_{0,0} via the reverse Schur recursion
        # (carry-only; one batched Cholesky - or Newton - chain of
        # depth m-1).
        def rev(s_prev, inputs):
            a_j, u_j = inputs
            x = inv_fn(s_prev)
            s_new = a_j - u_j @ x @ jnp.swapaxes(u_j, -1, -2)
            s_new = 0.5 * (s_new + jnp.swapaxes(s_new, -1, -2))
            return s_new, None

        if m >= 3:
            s0, _ = jax.lax.scan(rev, a_int[-1], (a_int[:-1], u_int),
                                 reverse=True)
        else:
            s0 = a_int[-1]
        d0 = _batched_inv_spd(s0)

        # G = [T^-1]_{0,m-2} via x_j = -inv_j U_j x_{j+1}, x_{m-2} =
        # inv_{m-2} (carry-only batched matmul chain).
        def chain(x, inputs):
            inv_j, u_j = inputs
            return -(inv_j @ (u_j @ x)), None

        if m >= 3:
            g_cor, _ = jax.lax.scan(chain, dm, (invs[:-1], u_int),
                                    reverse=True)
        else:
            g_cor = dm

        bt = jnp.swapaxes(b_cpl, -1, -2)
        ct = jnp.swapaxes(c_cpl, -1, -2)
        d0_next = jnp.roll(d0, -1, axis=0)  # garbage at C-1: c_cpl=0
        ahat = a_if - bt @ dm @ b_cpl - c_cpl @ d0_next @ ct
        ahat = 0.5 * (ahat + jnp.swapaxes(ahat, -1, -2))
        uhat = -(c_cpl[:-1] @ g_cor[1:] @ b_cpl[1:])
        red = block_thomas_factor(ahat, uhat)
    return PartitionedThomasFactor(chunk=chunk, red=red, b_cpl=b_cpl,
                                   c_cpl=c_cpl)


def _sub_batched(chunk: ThomasFactor, g_tm):
    """Batched chunk substitution, TIME-major: ``g_tm (m-1, C, M)``
    rows -> solution rows, same layout (block_thomas_substitute's math
    with a batch axis; reverse=True back pass, no flipped copies)."""
    invs, ws, up = chunk
    c, m_blk = g_tm.shape[1], g_tm.shape[2]

    def fwd(y_prev, inputs):
        w_k, b_k = inputs
        y_k = b_k - jnp.einsum("ci,cij->cj", y_prev, w_k)
        return y_k, y_k

    _, ys = jax.lax.scan(fwd, jnp.zeros((c, m_blk), invs.dtype),
                         (ws, g_tm))

    def bwd(x_next, inputs):
        inv_k, y_k, u_k = inputs
        x_k = jnp.einsum(
            "ci,cij->cj",
            y_k - jnp.einsum("ci,cji->cj", x_next, u_k), inv_k)
        return x_k, x_k

    _, xs = jax.lax.scan(bwd, jnp.zeros((c, m_blk), invs.dtype),
                         (invs, ys, up), reverse=True)
    return xs


def block_thomas_substitute_partitioned(fac: PartitionedThomasFactor,
                                        b):
    """Solve with a :class:`PartitionedThomasFactor`: two batched
    chunk substitutions (depth m-1) around one tiny reduced solve
    (depth C).  ``b`` is ``(N, M)`` rows; returns ``(N, M)``.
    """
    c = fac.b_cpl.shape[0]
    m = fac.chunk.invs.shape[0] + 1
    m_blk = b.shape[-1]
    g = b.reshape(c, m, m_blk)
    g_int = jnp.swapaxes(g[:, :m - 1], 0, 1)  # time-major (m-1, C, M)
    f = g[:, m - 1]

    with jax.default_matmul_precision("highest"):
        r = _sub_batched(fac.chunk, g_int)
        # bhat_c = f_c - r_c[m-2] B_c - r_{c+1}[0] C_c^T  (row forms of
        # B^T x and C x).
        r_next0 = jnp.roll(r[0], -1, axis=0)  # garbage at C-1: C=0
        bhat = (f - _rowmat(r[m - 2], fac.b_cpl)
                - _rowmat(r_next0, jnp.swapaxes(fac.c_cpl, -1, -2)))
        s = block_thomas_substitute(fac.red, bhat)  # (C, M) rows
        # g' = g - e_{m-2} B_c s_c - e_0 C_{c-1}^T s_{c-1}
        s_prev = jnp.roll(s, 1, axis=0)
        c_prev = jnp.roll(fac.c_cpl, 1, axis=0)
        corr_last = _rowmat(s, jnp.swapaxes(fac.b_cpl, -1, -2))
        corr_first = _rowmat(s_prev, c_prev)
        corr_first = corr_first.at[0].set(0.0)  # chunk 0 has no left
        g2 = g_int.at[m - 2].add(-corr_last)
        g2 = g2.at[0].add(-corr_first)
        u = _sub_batched(fac.chunk, g2)
        # interleave back: (m-1, C, M) interiors + (C, M) interfaces
        x = jnp.concatenate(
            [jnp.swapaxes(u, 0, 1), s[:, None]], axis=1)  # (C, m, M)
    return x.reshape(c * m, m_blk)


def _rowmat(rows, mats):
    """Batched row-vector x matrix: ``(C, M) @ (C, M, M) -> (C, M)``."""
    return jnp.einsum("ci,cij->cj", rows, mats)


def block_thomas_solve(diag, upper, b):
    """Solve the symmetric block-tridiagonal system via block Thomas.

    System: ``diag[k] x_k + upper[k] x_{k+1} + upper[k-1]^T x_{k-1} = b_k``.

    Forward elimination factoring each Schur complement with Cholesky
    (the system is symmetrized and Jacobi-prescaled upstream, which
    keeps the f32 recursion in PD range; a NaN factor here means the
    prescaled system itself lost PD-ness) and carrying the explicit
    inverse, then back substitution; both are ``lax.scan`` of length N.

    Args:
        diag: ``(N, M, M)``; upper: ``(N-1, M, M)``; b: ``(N, M)`` - or
            ``(N, K, M)`` for K independent right-hand sides (row
            convention: row r of block k is rhs r's block-k segment;
            used by the pose-sharded substructured solver to push the
            interface coupling columns through one factorization).

    Returns:
        ``(N, M)`` solution (or ``(N, K, M)`` matching the rhs rank).
    """
    n, m = diag.shape[0], diag.shape[1]
    up = jnp.concatenate([upper, jnp.zeros((1, m, m), diag.dtype)], axis=0)
    eye = jnp.eye(m, dtype=diag.dtype)

    # A TF32 (or lower) matmul precision would break the Schur-complement
    # recursion: it needs full f32 or it loses positive-definiteness and
    # the solve accuracy GN depends on.  The recursion carries EXPLICIT
    # inverses (Cholesky factor -> triangular inverse -> S^-1) rather
    # than cho_solve-ing vectors: a vector solve routes through an
    # (m, 1) intermediate whose stacked remat copies tile-pad 1 -> 128
    # in the scan (a compile-time OOM at 100k poses); with inverses every saved tensor is (m, m) and
    # every vector op is a clean matvec.
    # Vectors ride as (1, m) ROWS end-to-end: an (m,) vector in a
    # matmul becomes an (m, 1) operand whose scan-stacked buffers may get
    # a tile-padded layout, while a (1, m) row pads far less.
    squeeze = b.ndim == 2
    b_row = b[:, None, :] if squeeze else b  # (n, K, m)
    n_rhs = b_row.shape[1]
    with jax.default_matmul_precision("highest"):
        def fwd(carry, inputs):
            inv_prev, y_prev, u_prev = carry
            a_k, u_k, b_k = inputs
            w = inv_prev @ u_prev  # S_{k-1}^{-1} U_{k-1}
            s_k = a_k - u_prev.T @ w
            s_k = 0.5 * (s_k + s_k.T)
            rhs = b_k - y_prev @ w  # (1, m); (W^T y)^T == y^T W
            chol_k = jnp.linalg.cholesky(s_k)
            li = jax.lax.linalg.triangular_solve(
                chol_k, eye, left_side=True, lower=True)
            inv_k = li.T @ li  # S_k^-1 = L^-T L^-1
            return (inv_k, rhs, u_k), (inv_k, rhs)

        init = (eye, jnp.zeros((n_rhs, m), diag.dtype),
                jnp.zeros((m, m), diag.dtype))
        _, (invs, ys) = jax.lax.scan(fwd, init, (diag, up, b_row))

        def bwd(x_next, inputs):
            inv_k, y_k, u_k = inputs
            # x = S^-1 (y - U x_next); S^-1 symmetric, so the row form
            # is (y_row - x_next_row U^T) S^-1.
            x_k = (y_k - x_next @ u_k.T) @ inv_k
            return x_k, x_k

        _, xs_rev = jax.lax.scan(
            bwd, jnp.zeros((n_rhs, m), diag.dtype),
            (invs[::-1], ys[::-1], up[::-1]))
        return xs_rev[::-1, 0, :] if squeeze else xs_rev[::-1]


def pad_band(h_band, b, multiple: int):
    """Pad the trajectory axis to a multiple with decoupled identity
    blocks (their solution is exactly 0 for the zero RHS padding)."""
    d1, t1 = h_band.shape[0], h_band.shape[1]
    pad = (-t1) % multiple
    if pad:
        eye_tail = jnp.zeros((d1, pad, 3, 3), h_band.dtype)
        eye_tail = eye_tail.at[0].set(jnp.eye(3, dtype=h_band.dtype))
        h_band = jnp.concatenate([h_band, eye_tail], axis=1)
        b = jnp.concatenate([b, jnp.zeros((pad, 3), b.dtype)], axis=0)
    return h_band, b


def jacobi_prescale(h_band, b):
    """Symmetric Jacobi scaling s_i = 1/sqrt(H_ii) per scalar row.

    The graph's 1e4 gauge anchor otherwise pushes the f32 Schur
    recursions out of PD range.  Returns ``(h_scaled, b_scaled, s)``;
    un-scale a solution with ``x * s``.
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    diag_scal = jnp.diagonal(h_band[0], axis1=-2, axis2=-1)  # (T1, 3)
    s = jax.lax.rsqrt(jnp.maximum(diag_scal, 1e-30))  # (T1, 3)
    # hb'[d, i, a, bcol] = hb * s[i, a] * s[i+d, bcol]
    idx = jnp.minimum(jnp.arange(t1)[None, :] + jnp.arange(d1)[:, None],
                      t1 - 1)
    s_col = s[idx]  # (D, T1, 3)
    h_scaled = h_band * s[None, :, :, None] * s_col[:, :, None, :]
    return h_scaled, b * s, s


def _flat_prescale(h_flat, b_flat, band: int):
    """Flat-layout Jacobi prescale: s = 1/sqrt(diag), applied as row
    products (``h'[d*9+3a+b, i] = h * s[a, i] * s[b, i+d]``)."""
    d1 = band + 1
    t1 = h_flat.shape[1]
    diag = jnp.stack([h_flat[0], h_flat[4], h_flat[8]])  # (3, T1)
    s = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
    # s shifted by each diagonal offset (clamped at the end).
    shifts = [jnp.concatenate(
        [s[:, d:], jnp.repeat(s[:, -1:], d, axis=1)], axis=1)
        if d else s for d in range(d1)]
    s_shift = jnp.stack(shifts)  # (D, 3, T1)
    s_a = jnp.tile(jnp.repeat(s, 3, axis=0)[None], (d1, 1, 1))
    s_b = jnp.tile(s_shift, (1, 3, 1))
    scale = (s_a * s_b).reshape(d1 * 9, t1)
    return h_flat * scale, b_flat * s, s


def _flat_to_tridiag(h_flat, band: int, super_size: int,
                     drop_last: bool = True):
    """Super-block densification straight from flat banded storage.

    Builds the scalar diagonal strips ``val_o[3i+a] = H-scalar on
    global scalar diagonal o`` (the G-matrix column is simply ``a + o``)
    and places them into dense ``(N, 3S, 3S)`` blocks with two one-hot
    batched matmuls (each output scalar has EXACTLY ONE contributing
    strip, so HIGHEST precision reproduces f32 bit-exactly).  No
    intermediate ever carries trailing (3, 3) dims, whose tile-padded
    layouts OOM beyond ~150k poses (see assemble_banded_flat).
    """
    if band > super_size:
        raise ValueError(f"band {band} exceeds super block size "
                         f"{super_size}")
    d1 = band + 1
    t1 = h_flat.shape[1]
    n = t1 // super_size
    s3 = 3 * super_size
    n_o = 3 * band + 3  # scalar diagonals 0 .. 3*band+2

    # Strip values per row phase a: va[i, o] = the scalar H entry on
    # scalar diagonal o at scalar row 3i+a, which lives at flat column
    # d*9 + 3a + b with 3d + b = a + o.  Each va is a STATIC column
    # gather of the 2-D transposed flat storage - no intermediate ever
    # carries a small trailing dim (tile-padded layouts of (.., 3, ..)
    # tensors OOM the compile at 100k-1M poses).
    ht = jnp.concatenate(
        [h_flat.T, jnp.zeros((t1, 1), h_flat.dtype)], axis=1)
    zero_col = 9 * d1  # appended zero column
    vas = []
    for a in range(3):
        cols = []
        for o in range(n_o):
            c = a + o
            d, b = divmod(c, 3)
            cols.append(d * 9 + 3 * a + b if d <= band else zero_col)
        vas.append(ht[:, jnp.asarray(cols)].reshape(n, super_size, n_o))

    # Per-phase placement + one-hot row interleave (p = 3s + a), all as
    # exact one-hot matmuls (each output scalar has exactly one
    # contributing term; HIGHEST precision reproduces f32 bit-exactly).
    # One-hots are built on device, not as baked literals.
    s_i = jnp.arange(super_size)
    o_i = jnp.arange(n_o)
    j_i = jnp.arange(s3)
    diag_u = jnp.zeros((n, s3, s3), h_flat.dtype)
    upper = jnp.zeros((n, s3, s3), h_flat.dtype)
    for a in range(3):
        p_of_s = 3 * s_i + a  # scalar row of block-row s, phase a
        w_d = ((p_of_s[:, None, None] + o_i[None, :, None])
               == j_i[None, None, :]).astype(h_flat.dtype)
        w_u = ((p_of_s[:, None, None] + o_i[None, :, None] - s3)
               == j_i[None, None, :]).astype(h_flat.dtype)
        rows_a = (j_i[:, None] == p_of_s[None, :]).astype(h_flat.dtype)
        da = jnp.einsum("kso,soj->ksj", vas[a], w_d,
                        precision=jax.lax.Precision.HIGHEST)
        ua = jnp.einsum("kso,soj->ksj", vas[a], w_u,
                        precision=jax.lax.Precision.HIGHEST)
        diag_u = diag_u + jnp.einsum(
            "ps,ksj->kpj", rows_a, da,
            precision=jax.lax.Precision.HIGHEST)
        upper = upper + jnp.einsum(
            "ps,ksj->kpj", rows_a, ua,
            precision=jax.lax.Precision.HIGHEST)
    # Scalar-symmetric completion of the diagonal blocks (only scalar
    # diagonals o >= 0 were placed).
    diag = diag_u + jnp.triu(diag_u, 1).swapaxes(-1, -2)
    # upper[n-1] couples to the block AFTER this storage's last - zero
    # for a whole matrix, but the live cross-chunk coupling when the
    # caller holds one shard of a pose-sharded system (drop_last=False).
    return diag, (upper[:-1] if drop_last else upper)


def pad_flat(h_flat, b_flat, multiple: int):
    """Flat-layout twin of :func:`pad_band`: pad the trajectory axis to
    a multiple with decoupled identity scalar blocks."""
    t1 = h_flat.shape[1]
    pad = (-t1) % multiple
    if pad:
        h_flat = jnp.pad(h_flat, ((0, 0), (0, pad)))
        for k in (0, 4, 8):
            h_flat = h_flat.at[k, t1:].set(1.0)
        b_flat = jnp.pad(b_flat, ((0, 0), (0, pad)))
    return h_flat, b_flat


def _row_interleave_hot(super_size: int, dtype):
    """(3, 3S, S) one-hot: scalar row p = 3s + a of a super-block from
    phase row a, block-row s.  A (T1, 3)-shaped transpose would tile-pad
    3 -> 128 at scale; the one-hot matmul keeps layouts clean and is
    exact (one term per output scalar)."""
    s_i = jnp.arange(super_size)
    j_i = jnp.arange(3 * super_size)
    return jnp.stack([
        (j_i[:, None] == (3 * s_i + a)[None, :]).astype(dtype)
        for a in range(3)])


def flat_rows_to_super(b_s, super_size: int):
    """Interleave ``(3, T1)`` phase rows into ``(N, 3S)`` scalar order."""
    n = b_s.shape[1] // super_size
    r_hot = _row_interleave_hot(super_size, b_s.dtype)
    b_blk = b_s.reshape(3, n, super_size)
    return jnp.einsum("aps,aks->kp", r_hot, b_blk,
                      precision=jax.lax.Precision.HIGHEST)


def super_rows_to_flat(x, super_size: int):
    """Inverse of :func:`flat_rows_to_super`: ``(N, 3S)`` -> ``(3, T1)``."""
    n = x.shape[0]
    r_hot = _row_interleave_hot(super_size, x.dtype)
    x3 = jnp.einsum("aps,kp->aks", r_hot, x,
                    precision=jax.lax.Precision.HIGHEST)
    return x3.reshape(3, n * super_size)


def banded_solve_tridiag_flat(h_flat, b_flat, band: int,
                              super_size: int | None = None):
    """Flat-layout twin of :func:`banded_solve_tridiag`.

    Same math (pad + Jacobi prescale + super-block Thomas), but every
    intermediate keeps the trajectory axis minor: scales to 1M+ poses
    where the (D, T1, 3, 3) pipeline OOMs on tile-padded layouts.
    """
    t1 = h_flat.shape[1]
    if super_size is None:
        super_size = max(band, 1)
    h_flat, b_flat = pad_flat(h_flat, b_flat, super_size)
    t_pad = h_flat.shape[1]

    with jax.default_matmul_precision("highest"):
        h_s, b_s, s = _flat_prescale(h_flat, b_flat, band)
        diag, upper = _flat_to_tridiag(h_s, band, super_size)
        b_sup = flat_rows_to_super(b_s, super_size)
        x = block_thomas_solve(diag, upper, b_sup)
        x3 = super_rows_to_flat(x, super_size) * s
    return x3.T[:t1]


class TridiagFlatFactor(typing.NamedTuple):
    """Reusable factorization of a flat banded system (prescale + Thomas
    factor); solve new right-hand sides with
    :func:`banded_resolve_tridiag_flat`."""

    factor: ThomasFactor
    s: jax.Array  # (3, T_pad) Jacobi prescale rows


def banded_factor_tridiag_flat(h_flat, band: int,
                               super_size: int | None = None,
                               n_parts: int | None = None
                               ) -> TridiagFlatFactor:
    """Factor a flat banded system once for many right-hand sides.

    :func:`banded_solve_tridiag_flat` staged: pad + Jacobi prescale +
    super-block densification + :func:`block_thomas_factor`.  The flat
    GN loop with constant H (exact Jacobians, frozen Omega) calls this
    once and then only :func:`banded_resolve_tridiag_flat` per
    iteration — the factorization (O(S^3) Cholesky/Schur per block) is
    the dominant cost of a solve; the substitution is O(S^2) matvecs.

    ``n_parts``: partition the super-block chain into that many chunks
    (:func:`block_thomas_factor_partitioned`) — factor and substitution
    scans drop from depth N to N/n_parts, batched.  The trajectory is
    padded up to a ``super_size * n_parts`` multiple.  Numerics: same
    recursion per chunk, reduced interface system solved in the same
    Cholesky/Schur arithmetic; results agree with the sequential factor
    to solver roundoff, not bitwise.
    """
    if super_size is None:
        super_size = max(band, 1)
    quantum = (super_size * n_parts if n_parts else super_size)
    h_flat, _ = pad_flat(h_flat, jnp.zeros((3, h_flat.shape[1]),
                                           h_flat.dtype), quantum)
    with jax.default_matmul_precision("highest"):
        h_s, _, s = _flat_prescale(
            h_flat, jnp.zeros((3, h_flat.shape[1]), h_flat.dtype), band)
        diag, upper = _flat_to_tridiag(h_s, band, super_size)
        if n_parts:
            fac = block_thomas_factor_partitioned(diag, upper, n_parts)
        else:
            fac = block_thomas_factor(diag, upper)
        return TridiagFlatFactor(factor=fac, s=s)


def banded_resolve_tridiag_flat(fac: TridiagFlatFactor, b_flat,
                                super_size: int) -> jax.Array:
    """Solve ``H x = b`` with a precomputed :class:`TridiagFlatFactor`.

    Bit-identical to :func:`banded_solve_tridiag_flat` on the same
    ``(h_flat, b_flat)`` (the prescale/interleave/substitution ops run
    in the same order; with a partitioned factor, agreement is to
    solver roundoff instead).  Returns ``(T1, 3)`` like the one-shot
    solver.
    """
    t1 = b_flat.shape[1]
    t_pad = fac.s.shape[1]
    b_flat = jnp.pad(b_flat, ((0, 0), (0, t_pad - t1)))
    with jax.default_matmul_precision("highest"):
        b_s = b_flat * fac.s
        b_sup = flat_rows_to_super(b_s, super_size)
        if isinstance(fac.factor, PartitionedThomasFactor):
            x = block_thomas_substitute_partitioned(fac.factor, b_sup)
        else:
            x = block_thomas_substitute(fac.factor, b_sup)
        x3 = super_rows_to_flat(x, super_size) * fac.s
    return x3.T[:t1]


@highest_matmul_precision
def banded_solve_tridiag(h_band, b, super_size: int | None = None):
    """One-shot H x = b via super-block tridiagonalization + block Thomas.

    Pads the trajectory axis to a super-block multiple (see
    :func:`pad_band`) and symmetrically Jacobi-prescales the system
    (:func:`jacobi_prescale`).
    """
    d1, t1 = h_band.shape[0], h_band.shape[1]
    band = d1 - 1
    if super_size is None:
        super_size = max(band, 1)
    h_band, b = pad_band(h_band, b, super_size)
    t_pad = h_band.shape[1]
    n = t_pad // super_size

    h_scaled, b_scaled, s = jacobi_prescale(h_band, b)
    diag, upper = band_to_tridiag(h_scaled, super_size)
    x = block_thomas_solve(diag, upper,
                           b_scaled.reshape(n, 3 * super_size))
    return (x.reshape(t_pad, 3) * s)[:t1]
