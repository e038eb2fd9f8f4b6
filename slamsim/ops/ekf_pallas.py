"""Fused batched EKF-SLAM rollout as one Pallas kernel, through Triton.

The whole N-step sim+filter rollout (the math of
``slamsim.filters.ekf.ekf_step_with_noise``, itself parity with
extended_kalman_filter.py:86-130) runs in one kernel launch.

Design:
  * One rollout per lane.  A block holds a power of two of rollouts and
    runs the step loop itself, so the carry - dead reckoning, estimate,
    the 3x3 covariance and two accumulators, 17 floats - stays in
    registers for the whole rollout, and each rollout writes its results
    once.  The XLA scan (``filters.ekf.ekf_rollout_batch``) moves that
    carry, its noise and its per-step outputs through device memory at
    every step.
  * No matrix products: the Jacobian and covariance products are
    unrolled into scalar multiply-adds, as the work is elementwise per
    rollout.
  * Ground truth is the same on every lane, so it is precomputed in XLA
    as a per-step table ``[x, y, yaw, cos(yaw), sin(yaw)]`` (with the
    scan oracle's own ops) and read per step as scalars.
  * Noise comes from a counter-based generator (:mod:`slamsim.ops.rng`)
    keyed by (seed, global rollout index) with counter (step, draw).  A
    rollout's stream therefore does not depend on the block size or on
    how a sweep is sharded.  It is not ``jax.random``'s stream: results
    agree with the scan path in distribution, and bit for bit with the
    noise off.
  * The accumulators are the reference's Monte-Carlo statistics
    (scripts/gen_ref_distributions.py): the squared position error of
    the prior estimate ``x_pre``, and the NEES of the prior error under
    the posterior covariance, summed over steps.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from slamsim.filters.ekf import EkfConfig, EkfState
from slamsim.ops import rng

_TWO_PI = 2.0 * math.pi
_TABLE_COLS = 5


def _wrap(a):
    """Closed-form equivalent of mylib/limit.py:11-26."""
    mag = jnp.abs(a)
    k = jnp.maximum(jnp.ceil((mag - math.pi) / _TWO_PI), 0.0)
    w = mag - _TWO_PI * k
    return jnp.where(a < 0, -w, w)


# Measured on one H100 (PERF.md): 128-rollout blocks of 4 warps are the
# fastest at 8M rollouts; at 8192 rollouts the block size does not matter.
_MIN_BLOCK = 32
_MAX_BLOCK = 128
# Several blocks per SM of a 132-SM card.
_MIN_GRID = 4 * 132


def launch_shape(batch: int) -> tuple[int, int]:
    """``(block, num_warps)`` for a batch of rollouts: one rollout per
    thread, and blocks only as large as still gives ``_MIN_GRID``
    blocks, so that a small batch spreads over every SM."""
    block = _MIN_BLOCK
    while block < _MAX_BLOCK and batch >= _MIN_GRID * 2 * block:
        block *= 2
    return block, block // 32


def _ekf_kernel(meta_ref, tbl_ref, *out_refs, cfg: EkfConfig, n_steps: int,
                noise_on: bool, with_nees: bool, block: int):
    v, w, dt = cfg.vel, cfg.yaw_rate, cfg.dt
    q0, q1, q2 = (s * s for s in cfg.q_std)
    r0sq, r1sq = (s * s for s in cfg.r_std)
    qa0, qa1, qa2 = cfg.q_act_std
    ra0, ra1 = cfg.r_act_std

    shape = (block,)
    if noise_on:
        key0 = meta_ref[0]
        key1 = (meta_ref[1] + pl.program_id(0) * block
                + jax.lax.broadcasted_iota(jnp.int32, shape, 0))

    def step(i, carry):
        (xd0, xd1, xd2, xh0, xh1, xh2,
         p00, p01, p02, p10, p11, p12, p20, p21, p22, acc, acc_n) = carry

        if noise_on:
            n = rng.normals(key0, key1, i, 5)
        else:
            n = [0.0] * 5

        # --- ground truth (extended_kalman_filter.py:97), from the table.
        xt0 = tbl_ref[_TABLE_COLS * i]
        xt1 = tbl_ref[_TABLE_COLS * i + 1]
        xt2 = tbl_ref[_TABLE_COLS * i + 2]
        c_t = tbl_ref[_TABLE_COLS * i + 3]
        s_t = tbl_ref[_TABLE_COLS * i + 4]

        # --- observation: robot-frame noise rotated to world (:100-101).
        # The rotation angle is yaw - pi/2: cos = sin(yaw), sin = -cos(yaw).
        wx = n[0] * ra0
        wy = n[1] * ra1
        z0 = s_t * wx + c_t * wy + xt0
        z1 = -c_t * wx + s_t * wy + xt1

        # --- dead reckoning (:104-106) -----------------------------------
        c_d, s_d = jnp.cos(xd2), jnp.sin(xd2)
        xd0 = xd0 + v * dt * c_d + n[2] * qa0
        xd1 = xd1 + v * dt * s_d + n[3] * qa1
        xd2 = _wrap(xd2 + w * dt + n[4] * qa2)

        # --- predict (:109-115) ------------------------------------------
        c_h, s_h = jnp.cos(xh2), jnp.sin(xh2)
        xp0 = xh0 + v * dt * c_h
        xp1 = xh1 + v * dt * s_h
        xp2 = _wrap(xh2 + w * dt)
        a = -dt * v * s_h  # jF[0,2]
        b = dt * v * c_h  # jF[1,2]
        # M = jF P  (rows 0,1 pick up a,b times row 2)
        m00 = p00 + a * p20
        m01 = p01 + a * p21
        m02 = p02 + a * p22
        m10 = p10 + b * p20
        m11 = p11 + b * p21
        m12 = p12 + b * p22
        # P- = M jF^T + Q  (cols 0,1 pick up a,b times col 2)
        p00 = m00 + a * m02 + q0
        p01 = m01 + b * m02
        p02 = m02
        p10 = m10 + a * m12
        p11 = m11 + b * m12 + q1
        p12 = m12
        p20, p21, p22 = p20 + a * p22, p21 + b * p22, p22 + q2

        # --- update (:117-128); analytic 2x2 innovation inverse ----------
        s00 = p00 + r0sq
        s11 = p11 + r1sq
        inv = 1.0 / (s00 * s11 - p01 * p10)
        i00 = s11 * inv
        i01 = -p01 * inv
        i10 = -p10 * inv
        i11 = s00 * inv
        g00 = p00 * i00 + p01 * i10
        g01 = p00 * i01 + p01 * i11
        g10 = p10 * i00 + p11 * i10
        g11 = p10 * i01 + p11 * i11
        g20 = p20 * i00 + p21 * i10
        g21 = p20 * i01 + p21 * i11
        e0 = z0 - xp0
        e1 = z1 - xp1
        xh0 = xp0 + g00 * e0 + g01 * e1
        xh1 = xp1 + g10 * e0 + g11 * e1
        xh2 = _wrap(xp2 + g20 * e0 + g21 * e1)
        # P = P- - G (C P-)  with C P- = rows 0,1 of P-
        n00 = p00 - (g00 * p00 + g01 * p10)
        n01 = p01 - (g00 * p01 + g01 * p11)
        n02 = p02 - (g00 * p02 + g01 * p12)
        n10 = p10 - (g10 * p00 + g11 * p10)
        n11 = p11 - (g10 * p01 + g11 * p11)
        n12 = p12 - (g10 * p02 + g11 * p12)
        n20 = p20 - (g20 * p00 + g21 * p10)
        n21 = p21 - (g20 * p01 + g21 * p11)
        n22 = p22 - (g20 * p02 + g21 * p12)

        # --- Monte-Carlo statistics of the prior estimate ----------------
        d0 = xp0 - xt0
        d1 = xp1 - xt1
        acc = acc + d0 * d0 + d1 * d1
        if with_nees:
            # e' P^-1 e through the adjugate: (e' adj(P) e) / det(P).
            d2 = _wrap(xp2 - xt2)
            c00 = n11 * n22 - n12 * n21
            c01 = n12 * n20 - n10 * n22
            c02 = n10 * n21 - n11 * n20
            c10 = n02 * n21 - n01 * n22
            c11 = n00 * n22 - n02 * n20
            c12 = n01 * n20 - n00 * n21
            c20 = n01 * n12 - n02 * n11
            c21 = n02 * n10 - n00 * n12
            c22 = n00 * n11 - n01 * n10
            det = n00 * c00 + n01 * c01 + n02 * c02
            quad = (d0 * (c00 * d0 + c10 * d1 + c20 * d2)
                    + d1 * (c01 * d0 + c11 * d1 + c21 * d2)
                    + d2 * (c02 * d0 + c12 * d1 + c22 * d2))
            acc_n = acc_n + quad / det

        return (xd0, xd1, xd2, xh0, xh1, xh2,
                n00, n01, n02, n10, n11, n12, n20, n21, n22, acc, acc_n)

    p0 = [s * s for s in cfg.p0_std]
    init = [cfg.x0[k] for k in range(3)] * 2 + [
        p0[r] if r == c else 0.0 for r in range(3) for c in range(3)]
    init = tuple(jnp.full(shape, c, jnp.float32) for c in init + [0.0, 0.0])
    out = jax.lax.fori_loop(0, n_steps, step, init)
    for ref, val in zip(out_refs, out):
        ref[...] = val


@functools.partial(jax.jit,
                   static_argnames=("cfg", "batch", "n_steps", "noise_on",
                                    "with_nees", "interpret"))
def ekf_fused_rollout(cfg: EkfConfig, seed, batch: int, n_steps: int,
                      noise_on: bool = True, with_nees: bool = False,
                      interpret: bool = False, first_index=0):
    """Run ``batch`` fused EKF rollouts of ``n_steps`` in one kernel.

    Args:
        cfg: static EKF config (reference defaults).
        seed: int32 scalar; with ``first_index`` it keys the noise.
        batch: number of independent rollouts (any size; the grid is
            padded to whole blocks).
        n_steps: steps per rollout.
        noise_on: disable to get the deterministic noise-free trajectory
            (used by the exactness checks against the XLA scan path).
        interpret: run the kernel in the Pallas interpreter (tests on a
            machine without a GPU).
        first_index: global index of rollout 0.  Rollout ``i`` draws
            the stream of ``(seed, first_index + i)``, so a sweep split
            into slices (across devices, say) draws the same noise as
            one call over the whole batch.

    Returns:
        ``(EkfState, sum_sq_err)``: final batched state (pytree of
        ``(batch, ...)`` arrays) and the ``(batch,)`` sum over steps of
        the squared position error of the prior estimate (divide by
        ``n_steps`` and take the root for the rollout's RMSE).  With
        ``with_nees=True``, ``(EkfState, sum_sq_err, sum_nees)``: the
        sum over steps of the prior error's NEES under the posterior
        covariance (divide by ``n_steps``; the reference's mean is 1.18).
    """
    block, num_warps = launch_shape(batch)
    grid = -(-batch // block)
    padded = grid * block

    x0 = jnp.asarray(cfg.x0, jnp.float32)
    v, w, dt = cfg.vel, cfg.yaw_rate, cfg.dt

    def _truth(carry, _):
        t0, t1, t2 = carry
        t0 = t0 + v * dt * jnp.cos(t2)
        t1 = t1 + v * dt * jnp.sin(t2)
        t2 = _wrap(t2 + w * dt)
        return (t0, t1, t2), jnp.stack(
            [t0, t1, t2, jnp.cos(t2), jnp.sin(t2)])

    _, tbl = jax.lax.scan(_truth, (x0[0], x0[1], x0[2]), None,
                          length=n_steps)  # (n_steps, 5)
    meta = jnp.stack([jnp.asarray(seed, jnp.int32),
                      jnp.asarray(first_index, jnp.int32)])

    n_out = 17 if with_nees else 16
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    kernel = functools.partial(_ekf_kernel, cfg=cfg, n_steps=n_steps,
                               noise_on=noise_on, with_nees=with_nees,
                               block=block)
    out = pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec()] * 2,
        out_specs=[lane_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((padded,), jnp.float32)] * n_out,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="ekf_fused_rollout",
    )(meta, tbl.reshape(-1))
    out = jnp.stack(out)[:, :batch]

    final = EkfState(
        x_true=jnp.broadcast_to(tbl[-1, :3], (batch, 3)),
        x_dr=out[0:3].T, x_hat=out[3:6].T,
        cov=out[6:15].T.reshape(batch, 3, 3))
    if with_nees:
        return final, out[15], out[16]
    return final, out[15]
