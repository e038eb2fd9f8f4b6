"""Confidence error-ellipse parameters from a 2x2 covariance, batched.

Capability parity with the reference's ``mylib/error_ellipse.py:39-68``
(``ErrorEllipse.calc_error_ellipse`` / ``calc_chi``): eigendecompose the
covariance, scale the axes by the chi-squared quantile, and report the
major-axis angle.

Reference quirk reproduced behind a flag: mylib/error_ellipse.py:51 takes
``vec[idxmax]`` - a *row* of the eigenvector matrix rather than the column
eigenvector ``vec[:, idxmax]`` - so the reported ellipse angle comes from
the transposed eigenvector.  ``row_eigvec_compat=True`` (default) reproduces
that for pixel-identical rendering; ``False`` uses the mathematically
conventional column eigenvector.  Filter math is unaffected either way.
"""

from __future__ import annotations

import jax.numpy as jnp

from slamsim.core.chi2 import chi2_ppf_2dof_table


def error_ellipse(sigma, p_percent=99.0, row_eigvec_compat=True):
    """Compute (major_len, minor_len, angle_rad) of the p% error ellipse.

    Parity: mylib/error_ellipse.py:39-55.  Axis length = 2*sqrt(lambda*chi2).
    Batched: ``sigma`` may be ``(..., 2, 2)``.

    Args:
        sigma: ``(..., 2, 2)`` covariance.
        p_percent: confidence percentage (scalar).
        row_eigvec_compat: reproduce the reference's row-indexing quirk.

    Returns:
        Tuple ``(major, minor, angle_rad)`` each of shape ``(...)``.
    """
    sigma = jnp.asarray(sigma)
    chi2 = chi2_ppf_2dof_table(p_percent)
    val, vec = jnp.linalg.eigh(sigma)  # ascending eigenvalues
    # eigh returns ascending order: index 1 is the max, 0 the min.
    vmax = val[..., 1]
    vmin = val[..., 0]
    if row_eigvec_compat:
        # Reference reads the *row* at idxmax (mylib/error_ellipse.py:51).
        vecmax = vec[..., 1, :]
    else:
        vecmax = vec[..., :, 1]
    ang = jnp.arctan2(vecmax[..., 1], vecmax[..., 0])
    major = 2.0 * jnp.sqrt(vmax * chi2)
    minor = 2.0 * jnp.sqrt(vmin * chi2)
    return major, minor, ang


def major_axis_length(sigma, p_percent):
    """Major-axis length only (parity: mylib/error_ellipse.py:57-68)."""
    major, _, _ = error_ellipse(sigma, p_percent)
    return major
