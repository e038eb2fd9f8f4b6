"""Error-ellipse demo: confidence ellipse over Gaussian samples.

Parity with mylib/error_ellipse.py:70-116 (``__main__``): 1000 samples
from a correlated 2-D Gaussian with the 99% confidence ellipse overlaid.

Run::

    python -m slamsim.viz.demo_ellipse --save ellipse.png
"""

from __future__ import annotations

import argparse

import numpy as np

from slamsim.viz.render import draw_error_ellipse, save_or_show


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mu = np.array([24.0, 12.0])
    cov = np.array([[16.0, 5.48], [5.48, 9.0]])

    chol = jnp.linalg.cholesky(jnp.asarray(cov))
    n = jax.random.normal(jax.random.key(args.seed), (args.samples, 2))
    samples = np.asarray(n @ chol.T) + mu

    fig = plt.figure(facecolor="w")
    ax = fig.add_subplot(111, aspect="equal")
    ax.scatter(samples[:, 0], samples[:, 1], color="r", marker="x",
               label="$K_1$")
    draw_error_ellipse(ax, mu, cov, 99.0,
                       label="Confidence Interval: 99.00[%]")
    ax.set_xlabel("$x$", size=20)
    ax.set_ylabel("$y$", size=20)
    ax.set_title("Error Ellipse")
    ax.axis("equal")
    ax.grid(True)
    ax.legend()
    save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
