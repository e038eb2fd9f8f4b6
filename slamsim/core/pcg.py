"""Shared preconditioned-CG driver.

One implementation of the PCG iteration, stopping rule, and breakdown
guards, parameterized by ``(matvec, precond, dot)`` so the single-device
banded solver (:func:`slamsim.slam.large.cg_solve`) and the pose-sharded
solver (:mod:`slamsim.parallel.banded_shard`, where ``dot`` is a psum'd
reduction and ``matvec`` exchanges halos) cannot drift apart.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pcg(matvec, precond, dot, b, max_iters: int, tol: float):
    """Preconditioned conjugate gradients on ``H x = b``.

    Args:
        matvec: ``x -> H x`` (may involve collectives).
        precond: ``r -> M^{-1} r``.
        dot: inner product ``(a, c) -> scalar`` (psum'd when sharded).
        b: right-hand side (any array pytree leaf shape).
        max_iters / tol: stop when ``dot(r, r) <= tol * dot(b, b)``.

    Returns:
        ``(x, iters)``.  Breakdown-proof: vanishing curvature or a
        non-finite/negative ``r.z`` stops with the current iterate; a
        negligible ``b`` (norm^2 <= 1e-9) returns zero immediately; any
        non-finite solution is replaced by zeros.
    """
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    bnorm = dot(b, b)

    def body(carry):
        x, r, p, rz, it = carry
        hp = matvec(p)
        php = dot(p, hp)
        # Breakdown-proof: a vanishing curvature direction (converged or
        # semidefinite mode) yields a zero step, not an overflow.
        alpha = jnp.where(php > 1e-20, rz / jnp.maximum(php, 1e-20), 0.0)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 1e-30, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        p = z + beta * p
        return x, r, p, rz_new, it + 1

    def cond(carry):
        _, r, _, rz, it = carry
        return ((dot(r, r) > tol * bnorm) & (it < max_iters)
                & (rz > 0.0) & jnp.isfinite(rz))

    # Skip entirely when the gradient is negligible (a delta large enough
    # to matter to the GN ||dx||^2 threshold needs ||b|| >> this).
    def run(_):
        x, _, _, _, iters = jax.lax.while_loop(
            cond, body, (x0, r0, p0, rz0, jnp.asarray(0)))
        return jnp.where(jnp.isfinite(x), x, 0.0), iters

    return jax.lax.cond(bnorm > 1e-9, run,
                        lambda _: (x0, jnp.asarray(0)), None)
