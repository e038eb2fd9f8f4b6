"""Particle-filter localization demo: two panels (world + zoom).

Parity with the ``__main__`` + ``animate`` of particle_filter.py
(:240-346): landmark stars, particle cloud with heading quivers in the
zoom panel, truth (red) vs estimate (blue) trajectories, dashed
estimate-to-landmark segments, the ML-particle annotation box, and the
zoom window sized from ``calc_chi`` of Q (:322-324).

Run::

    python -m slamsim.viz.demo_pf --frames 360 --save pf.png
"""

from __future__ import annotations

import argparse

import numpy as np

from slamsim.viz.render import (draw_landmarks, draw_particles,
                                draw_trajectory, ellipse_params,
                                finalize_axes, save_animation,
                                save_or_show)


def render_frame(ax1, ax2, cfg, outs, upto):
    lm = np.asarray(cfg.landmarks)
    x_true = np.asarray(outs.x_true[:upto + 1])
    x_est = np.asarray(outs.x_est[:upto + 1])
    particles = np.asarray(outs.particles[upto])
    w_idx = int(np.asarray(outs.max_idx[upto]))
    w_val = float(np.asarray(outs.max_w[upto]))

    for ax in (ax1, ax2):
        draw_landmarks(ax, lm, label="Land Mark" if ax is ax1 else None)
        for i in range(lm.shape[0]):
            ax.plot([x_est[-1, 0], lm[i, 0]], [x_est[-1, 1], lm[i, 1]],
                    "--", c="green")
    draw_particles(ax1, particles)
    draw_particles(ax2, particles, quiver=True)
    draw_trajectory(ax1, x_true, "red", "Ground Truth")
    draw_trajectory(ax2, x_true, "red")
    draw_trajectory(ax1, x_est, "blue", "Estimation")
    draw_trajectory(ax2, x_est, "blue")

    txt = (f"Maximuim Likelihood Estimate:\n[Index]:{w_idx}\n"
           f"[Weight]:{w_val:.3f}")
    ax2.annotate(txt, xy=(x_est[-1, 0], x_est[-1, 1]), xycoords="data",
                 xytext=(0.55, 0.9), textcoords="axes fraction",
                 bbox=dict(boxstyle="round,pad=0.5", fc=(1.0, 0.7, 0.7)),
                 arrowprops=dict(arrowstyle="->", color="black"))

    finalize_axes(ax1, "Localization by PF")
    # Zoom window sized by calc_chi (the major-axis length) of Q's
    # position block, times 3 (particle_filter.py:322-324).
    q2 = np.diag(np.asarray(cfg.q_std[:2])) ** 2
    ee_l = ellipse_params(q2, 99.0)[0] * 3
    ax2.set_xlim(x_true[-1, 0] - ee_l, x_true[-1, 0] + ee_l)
    ax2.set_ylim(x_true[-1, 1] - ee_l, x_true[-1, 1] + ee_l)
    ax2.set_xlabel("x [m]")
    ax2.set_ylabel("y [m]")
    ax2.set_title("Zoom")
    ax2.grid(True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=360)
    ap.add_argument("--period-ms", type=float, default=100.0)
    ap.add_argument("--particles", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--animate", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slamsim.filters import PfConfig, pf_rollout

    cfg = PfConfig(dt=args.period_ms / 1000.0,
                   num_particles=args.particles)
    _, outs = jax.jit(
        lambda k: pf_rollout(cfg, k, args.frames, keep_particles=True))(
            jax.random.key(args.seed))
    outs = jax.device_get(outs)

    fig = plt.figure(figsize=(18, 9))
    ax1 = fig.add_subplot(1, 2, 1)
    ax2 = fig.add_subplot(1, 2, 2)
    if args.animate:
        from matplotlib import animation

        def frame(i):
            ax1.cla()
            ax2.cla()
            render_frame(ax1, ax2, cfg, outs, i)

        ani = animation.FuncAnimation(fig, frame, frames=args.frames,
                                      interval=args.period_ms, repeat=False)
        if args.save:
            save_animation(ani, args.save, fps=10)
        if args.show:
            plt.show()
    else:
        render_frame(ax1, ax2, cfg, outs, args.frames - 1)
        save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
