"""Matmul-precision control.

On the GPU, XLA's default precision lets a float32 matmul or einsum run
in TF32 on the tensor cores, which keeps about three decimal digits of
each operand.  That is harmless for elementwise filter math and
catastrophic inside linear-algebra recursions (Schur complements lose
positive-definiteness, CG stalls, GN keeps bouncing above its
convergence threshold).  Every product on the main path runs under
:func:`highest_matmul_precision`; decorate any new function whose
numerics depend on full f32 products with it.
"""

from __future__ import annotations

import functools

import jax


def highest_matmul_precision(fn):
    """Run ``fn`` (tracing included) under full-precision matmuls."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
