"""Counter-based random numbers for kernels: Threefry-2x32 + Box-Muller.

A kernel that runs a whole rollout in registers cannot call
``jax.random`` per step, so it draws from a counter-based generator
instead: every draw is a pure function of (key, counter), with no state
carried between draws.  The generator is Threefry-2x32 with 20 rounds,
the same function ``jax.random`` builds on; its bits equal
``jax.extend.random.threefry_2x32`` for the same key and counter
(tests/test_ops.py).

Everything is written in 32-bit integer adds, xors and shifts, so it
lowers inside a Pallas kernel and runs in interpret mode on the CPU.
The words are int32 with logical right shifts: two's-complement
wrap-around gives the same bits as uint32 arithmetic.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KEY_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return (jax.lax.shift_left(x, jnp.int32(r))
            | jax.lax.shift_right_logical(x, jnp.int32(32 - r)))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) of counter ``(c0, c1)`` under key
    ``(k0, k1)``; int32 words in, two int32 words out.  Arguments
    broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _KEY_PARITY)
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def uniforms(bits0, bits1):
    """Two uniforms from two random words: the 24 high bits of each.

    The first lies in ``(0, 1)`` (half an ulp keeps it off zero, for
    the logarithm of Box-Muller), the second in ``[0, 1)``.
    """
    scale = 1.0 / (1 << 24)
    u1 = (jax.lax.shift_right_logical(bits0, jnp.int32(8)).astype(
        jnp.float32) + 0.5) * scale
    u2 = jax.lax.shift_right_logical(bits1, jnp.int32(8)).astype(
        jnp.float32) * scale
    return u1, u2


def normals(k0, k1, step, count: int):
    """``count`` standard normals for one step of one stream.

    Stream = key ``(k0, k1)``; draw ``j`` of a step is Box-Muller on
    Threefry of counter ``(step, j // 2)``, so pair ``j // 2`` yields
    normals ``j`` and ``j + 1``.  Any argument may be a vector (one
    stream or step per lane).
    """
    out = []
    for pair in range((count + 1) // 2):
        u1, u2 = uniforms(*threefry2x32(k0, k1, step, pair))
        radius = jnp.sqrt(-2.0 * jnp.log(u1))
        cos, sin = sincos_turns(u2)
        out.append(radius * cos)
        out.append(radius * sin)
    return out[:count]


# sin(h) = h * P(h^2), cos(h) = Q(h^2) on h in [0, pi/2), least-squares
# fits on Chebyshev nodes.
_SIN_C = (0.9999999812130134, -0.16666649688716711,
          0.008332926736968374, -0.00019802254676520736,
          2.592816210455618e-06)
_COS_C = (0.9999999999054029, -0.4999999950367743,
          0.04166664009947133, -0.0013888400245756864,
          2.476182880839003e-05, -2.607709311324439e-07)


def sincos_turns(u):
    """``(cos, sin)`` of ``2*pi*u`` for ``u`` in ``[0, 1)``.

    Quadrant fold and quarter-turn polynomials, max abs error ~1.8e-7 in
    f32; one fold yields both values.  It takes the Box-Muller angle
    only, where the error is far below the sampling noise: in the fused
    EKF kernel on an H100 it ran ~3% faster than ``jnp.cos``/``jnp.sin``
    (PERF.md), while using it for the filter's own trig ran slower.
    """
    t = u * 4.0
    q = jnp.floor(t)
    h = (t - q) * (math.pi / 2.0)
    h2 = h * h
    sp = _SIN_C[-1]
    for c in _SIN_C[-2::-1]:
        sp = sp * h2 + c
    sp = h * sp
    cp = _COS_C[-1]
    for c in _COS_C[-2::-1]:
        cp = cp * h2 + c
    q1 = q == 1.0
    q2 = q == 2.0
    q3 = q == 3.0
    cos_v = jnp.where(q1, -sp, jnp.where(q2, -cp, jnp.where(q3, sp, cp)))
    sin_v = jnp.where(q1, cp, jnp.where(q2, -sp, jnp.where(q3, -cp, sp)))
    return cos_v, sin_v
