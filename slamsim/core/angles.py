"""Angle wrapping, vectorized.

Capability parity with the reference's scalar ``mylib/limit.py:11-26``
(``limit_angle``), which wraps an angle into [-pi, pi] by repeatedly
subtracting 2*pi from the magnitude and then restoring the sign.  The
reference implementation is a Python ``while`` loop and therefore scalar-only
and untraceable; here the identical mapping is expressed in closed form so it
vmaps/jits over arbitrary batch shapes.

Closed form: for magnitude m = |a|, the loop subtracts 2*pi exactly
k = max(0, ceil((m - pi) / (2*pi))) times, leaving m - 2*pi*k in (-pi, pi]
(note the loop may leave a *negative* value, e.g. 1.5*pi -> -0.5*pi, which
the sign-restore then flips; we reproduce exactly that behavior).
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def wrap_angle(angle):
    """Wrap angle(s) to the reference's limit_angle range.

    Exact functional equivalent of mylib/limit.py:11-26 for every float
    input (including |a| > 3*pi, which the reference handles by looping),
    but vectorized: works on any array shape.

    Args:
        angle: array of angles [rad], any shape.

    Returns:
        Wrapped angles, same shape.
    """
    a = jnp.asarray(angle)
    mag = jnp.abs(a)
    k = jnp.maximum(jnp.ceil((mag - jnp.pi) / TWO_PI), 0.0)
    wrapped = mag - TWO_PI * k
    return jnp.where(a < 0, -wrapped, wrapped)


def wrap_angle_fast(angle):
    """Branch-free wrap to (-pi, pi] via atan2.

    Not bit-identical to :func:`wrap_angle` at exact multiples of pi (a set
    of measure zero) but identical everywhere else up to float rounding.
    Preferred inside hot kernels where the trig units are already warm.
    """
    a = jnp.asarray(angle)
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))
