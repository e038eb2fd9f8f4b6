"""EKF localization demo: the reference's animated panel, in JAX.

Parity with the ``__main__`` + ``animate`` of extended_kalman_filter.py
(:208-291): ground-truth circle (red), observations (green scatter),
predicted trajectory (blue), 99% error ellipse at the current estimate,
and the per-step covariance printout (:264-265).

Device shape: the WHOLE rollout runs as one ``lax.scan`` on device;
the animation (or static final frame) replays host-side from the stacked
buffers.  Run::

    python -m slamsim.viz.demo_ekf --frames 360 --save ekf.png
    python -m slamsim.viz.demo_ekf --animate --save ekf.gif
"""

from __future__ import annotations

import argparse

import numpy as np

from slamsim.viz.render import (draw_error_ellipse, draw_trajectory,
                                finalize_axes, save_animation,
                                save_or_show)

CONFIDENCE = 99.0


def render_frame(ax, outs, upto, verbose=False):
    """Draw one frame from stacked rollout buffers (steps [0, upto])."""
    x_true = np.asarray(outs.x_true[:upto + 1])
    z = np.asarray(outs.z[:upto + 1])
    x_pre = np.asarray(outs.x_pre[:upto + 1])
    cov = np.asarray(outs.cov[upto])

    draw_trajectory(ax, x_true, "red", "Ground Truth")
    ax.scatter(z[:, 0], z[:, 1], c="green", marker="o", alpha=0.5,
               label="Observation")
    draw_trajectory(ax, x_pre, "blue", "Predicted")
    draw_error_ellipse(ax, x_pre[-1], cov[:2, :2], CONFIDENCE,
                       label=f"Error Ellipse: {CONFIDENCE:.2f}[%]")
    if verbose:
        print(f"time:{(upto + 1) * 0.1:.3f}[s], x-cov:{cov[0, 0]:.3f}[m], "
              f"y-cov:{cov[1, 1]:.3f}[m], xy-cov:{cov[1, 0]:.3f}[m]")
    finalize_axes(ax, "Localization by EKF")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=360)
    ap.add_argument("--period-ms", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--animate", action="store_true",
                    help="animated replay (gif via pillow) instead of the "
                         "final frame")
    ap.add_argument("--verbose", action="store_true",
                    help="per-step covariance printout like the reference")
    args = ap.parse_args(argv)

    import jax
    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slamsim.filters import EkfConfig, ekf_rollout

    cfg = EkfConfig(dt=args.period_ms / 1000.0)
    _, outs = jax.jit(lambda k: ekf_rollout(cfg, k, args.frames))(
        jax.random.key(args.seed))
    outs = jax.device_get(outs)  # one transfer for the whole rollout

    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(1, 1, 1)
    if args.animate:
        from matplotlib import animation

        def frame(i):
            ax.cla()
            render_frame(ax, outs, i, verbose=args.verbose)

        ani = animation.FuncAnimation(fig, frame, frames=args.frames,
                                      interval=args.period_ms, repeat=False)
        if args.save:
            save_animation(ani, args.save, fps=10)
        if args.show:
            plt.show()
    else:
        if args.verbose:
            cov = np.asarray(outs.cov)
            for i in range(args.frames):
                print(f"time:{(i + 1) * cfg.dt:.3f}[s], "
                      f"x-cov:{cov[i, 0, 0]:.3f}[m], "
                      f"y-cov:{cov[i, 1, 1]:.3f}[m], "
                      f"xy-cov:{cov[i, 1, 0]:.3f}[m]")
        render_frame(ax, outs, args.frames - 1)
        save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
