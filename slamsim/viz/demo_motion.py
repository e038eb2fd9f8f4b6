"""Motion-model sampling demo: the classic ch.5 'banana' scatter plots.

Parity with motion_model.py:91-144 (``__main__``): 500 noisy one-step
samples for three noise configurations from the same start pose
(translational-, rotational-, and heading-noise dominated).

Device shape: each 500-sample sweep is one ``vmap`` over keys (the
seed-sweep archetype, SURVEY.md section 3.4) instead of a Python loop.

Run::

    python -m slamsim.viz.demo_motion --samples 500 --save motion.png
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from slamsim.viz.render import save_or_show


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--samples", type=int, default=500)
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

    from slamsim.models import MotionConfig, motion_sample

    # Reference scenario (motion_model.py:93-115).
    radius = 1.0
    yaw_rate = math.radians(90.0)
    vel = radius * yaw_rate
    pose = jnp.array([radius, 0.0, math.pi / 2.0])

    configs = [
        ("red", "Sampling1",
         MotionConfig(dt=1.0, a1=0.05, a2=0.05, a3=0.01, a4=0.01, a5=0.01,
                      a6=0.01)),
        ("green", "Sampling2",
         MotionConfig(dt=1.0, a1=0.01, a2=0.01, a3=0.05, a4=0.05, a5=0.01,
                      a6=0.01)),
        ("blue", "Sampling3",
         MotionConfig(dt=1.0, a1=0.01, a2=0.01, a3=0.01, a4=0.01, a5=0.1,
                      a6=0.1)),
    ]

    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(1, 1, 1)
    key = jax.random.key(args.seed)
    for i, (color, label, cfg) in enumerate(configs):
        keys = jax.random.split(jax.random.fold_in(key, i), args.samples)
        samples = jax.vmap(
            lambda k: motion_sample(cfg, k, pose, vel, yaw_rate))(keys)
        s = np.asarray(samples)
        ax.scatter(s[:, 0], s[:, 1], c=color, marker="o", alpha=0.5,
                   label=label)

    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title("Sampling Test")
    ax.axis("equal")
    ax.grid(True)
    ax.legend(fontsize=10)
    save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
