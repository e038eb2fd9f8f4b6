"""Graph-based SLAM demo: two panels (world system + robot system).

Parity with the ``__main__`` + ``graph_based_slam`` callback and the
``Robot.draw`` family (graph_based_slam.py:717-986): actual trajectory
(red quivers), estimated trajectory (blue quivers), scan FOV arc,
true/actual landmark stars with error ellipses in both world and robot
frames, dashed robot-landmark segments, and the GN status text box
(iterations, ||dx||^2, det, cond).

Run::

    python -m slamsim.viz.demo_graph_slam --frames 18 --save slam.png
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from slamsim.viz.render import (draw_error_ellipse, draw_fov,
                                draw_landmarks, draw_poses_quiver,
                                finalize_axes, save_animation,
                                save_or_show)

BASE_ANG = math.pi / 2.0
CONFIDENCE = 99.0


def _world_cov(dist, bearing, yaw, scan_cfg):
    d2 = (dist * scan_cfg.dist_gain) ** 2
    b2 = (dist * math.sin(scan_cfg.dir_sigma)) ** 2
    ang = bearing + yaw - BASE_ANG
    c, s = math.cos(ang), math.sin(ang)
    return np.array([[c * c * d2 + s * s * b2, c * s * (d2 - b2)],
                     [c * s * (d2 - b2), s * s * d2 + c * c * b2]])


def _robot_cov(dist, bearing, scan_cfg):
    return _world_cov(dist, bearing, BASE_ANG, scan_cfg)


def render_frame(ax1, ax2, scene, graph_cfg, traj, poses_est, frames_out,
                 t):
    from slamsim.slam.frontend import observed_times_mask

    lm = np.asarray(scene.landmarks)
    actu = np.asarray(traj.poses_actu[:t + 1])
    # Reference getEstTrajPose (graph_based_slam.py:441-449): the estimated
    # trajectory is drawn only at observed times (isObs flag); unobserved
    # times hold raw odometry values the reference hides.
    is_obs = np.asarray(observed_times_mask(traj.obs))[:t + 1]
    est = np.asarray(poses_est[:t + 1])[is_obs]
    pose = actu[-1]
    scan_cfg = graph_cfg.scan

    # --- world panel ---------------------------------------------------
    draw_fov(ax1, pose, scan_cfg.range_m, scan_cfg.angle_rad)
    draw_landmarks(ax1, lm, label="Land Mark(True)")
    draw_poses_quiver(ax1, actu, "red", "Actual Trajectory")
    draw_poses_quiver(ax1, est, "blue", "Estimated Trajectory")

    dist = np.asarray(traj.obs.dist[t])
    bear = np.asarray(traj.obs.bearing[t])
    valid = np.asarray(traj.obs.valid[t])
    first = True
    pxs, pys = [], []
    for i in np.nonzero(valid)[0]:
        px = dist[i] * math.cos(bear[i] + pose[2] - BASE_ANG) + pose[0]
        py = dist[i] * math.sin(bear[i] + pose[2] - BASE_ANG) + pose[1]
        cov = _world_cov(dist[i], bear[i], pose[2], scan_cfg)
        draw_error_ellipse(
            ax1, (px, py), cov, CONFIDENCE,
            label=(f"Error Ellipse: {CONFIDENCE:.2f}[%]" if first else ""))
        ax1.plot([pose[0], px], [pose[1], py], "--", c="green")
        pxs.append(px)
        pys.append(py)
        first = False
    if pxs:
        ax1.scatter(pxs, pys, s=100, c="red", marker="*", alpha=0.5,
                    linewidths=2, edgecolors="red",
                    label="Land Mark(Actual)")

    is_calc = bool(np.asarray(frames_out.is_calc[t - 1])) if t >= 1 else \
        False
    iters = int(np.asarray(frames_out.gn_iters[t - 1])) if t >= 1 else 0
    dsum = float(np.asarray(frames_out.delta_sum[t - 1])) if t >= 1 else 0.0
    det = float(np.asarray(frames_out.det[t - 1])) if t >= 1 else 0.0
    cond = float(np.asarray(frames_out.cond[t - 1])) if t >= 1 else 0.0
    txt = ("<Status>\n Calculated Propriety: %s\n Number of Iterations: %d"
           "\n $\\sum \\, \\Delta{x}^T \\Delta{x}$: %e\n $det(H)$:%e\n "
           "Condition Number:%e" % ("OK" if is_calc else "NG", iters, dsum,
                                    det, cond))
    ax1.text(0.01, 0.99, txt, transform=ax1.transAxes, fontsize=10,
             verticalalignment="top",
             bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5))
    finalize_axes(ax1, "World System")

    # --- robot panel (true + actual sightings with ellipses) ------------
    true_d = np.asarray(traj.obs_true.dist[t])
    true_b = np.asarray(traj.obs_true.bearing[t])
    true_o = np.asarray(traj.obs_true.orient[t])
    gain = 2.0
    idx = np.nonzero(valid)[0]
    if idx.size:
        tx = true_d[idx] * np.cos(true_b[idx])
        ty = true_d[idx] * np.sin(true_b[idx])
        ax2.scatter(tx, ty, s=100, c="yellow", marker="*", alpha=0.5,
                    linewidths=2, edgecolors="orange",
                    label="Land Mark(True)")
        ax2.quiver(tx, ty, gain * np.cos(true_o[idx]),
                   gain * np.sin(true_o[idx]), color="orange",
                   angles="xy", scale_units="xy", scale=1)
        ox = dist[idx] * np.cos(bear[idx])
        oy = dist[idx] * np.sin(bear[idx])
        oo = np.asarray(traj.obs.orient[t])[idx]
        ax2.scatter(ox, oy, s=100, c="red", marker="*", alpha=0.5,
                    linewidths=2, edgecolors="red",
                    label="Land Mark(Actual)")
        ax2.quiver(ox, oy, gain * np.cos(oo), gain * np.sin(oo),
                   color="red", angles="xy", scale_units="xy", scale=1)
        first = True
        for k, i in enumerate(idx):
            cov = _robot_cov(dist[i], bear[i], scan_cfg)
            draw_error_ellipse(
                ax2, (ox[k], oy[k]), cov, CONFIDENCE,
                label=(f"Error Ellipse: {CONFIDENCE:.2f}[%]" if first
                       else ""))
            ax2.plot([0, ox[k]], [0, oy[k]], "--", c="green")
            first = False
    ax2.scatter(0, 0, s=100, c="blue", marker="o", alpha=0.5,
                label="Robot")
    ax2.quiver(0, 0, 0, 1, color="blue", angles="xy", scale_units="xy",
               scale=1)
    rng = scan_cfg.range_m + 5.0
    ax2.set_xlabel("x [m]")
    ax2.set_ylabel("y [m]")
    ax2.set_title("Robot System")
    ax2.axis([-rng, rng, -rng, rng])
    ax2.grid(True)
    ax2.legend(fontsize=10)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=18)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--animate", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="print the reference's per-GN-iteration Loop(n) "
                         "lines (graph_based_slam.py:709) for every frame")
    ap.add_argument("--course", choices=("circle", "wavy"),
                    default="circle",
                    help="circle = the reference demo's constant (v, w); "
                         "wavy = per-step controls (speed varies, turn "
                         "direction flips mid-run) via slam_rollout's "
                         "controls= argument")
    args = ap.parse_args(argv)

    import jax
    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slamsim.models.scan_sensor import ScanConfig
    from slamsim.slam import GraphConfig, SlamSceneConfig, slam_rollout

    scene = SlamSceneConfig()
    graph_cfg = GraphConfig(
        max_times=args.frames + 1, num_landmarks=len(scene.landmarks),
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)))
    controls = None
    if args.course == "wavy":
        import jax.numpy as jnp

        w = scene.yaw_rate
        controls = jnp.asarray(
            [[scene.vel * (1.0 + 0.2 * (i % 3)),
              w if i < args.frames // 2 else -w]
             for i in range(args.frames)], jnp.float32)
    traj, poses_est, frames_out = jax.jit(
        lambda k: slam_rollout(scene, graph_cfg, k, args.frames,
                               controls=controls))(
            jax.random.key(args.seed))
    traj, poses_est, frames_out = jax.device_get(
        (traj, poses_est, frames_out))

    if args.verbose:
        # Reference per-GN-iteration printout (graph_based_slam.py:709):
        # one "Loop(n)" line per Gauss-Newton iteration of every frame.
        for f in range(args.frames):
            print(f"Frame {f + 1}:")
            n_it = int(frames_out.gn_iters[f])
            for i in range(n_it):
                print(" Loop(%d): ||dx||^2 = %s, det = %s, cond = %s"
                      % (i + 1, frames_out.trace_delta_sum[f, i],
                         frames_out.trace_det[f, i],
                         frames_out.trace_cond[f, i]))

    fig = plt.figure(figsize=(18, 9))
    ax1 = fig.add_subplot(1, 2, 1, aspect="equal")
    ax2 = fig.add_subplot(1, 2, 2, aspect="equal")
    if args.animate:
        from matplotlib import animation

        def frame(i):
            ax1.cla()
            ax2.cla()
            render_frame(ax1, ax2, scene, graph_cfg, traj, poses_est,
                         frames_out, i)

        ani = animation.FuncAnimation(fig, frame, frames=args.frames + 1,
                                      interval=2000, repeat=False)
        if args.save:
            save_animation(ani, args.save, fps=1)
        if args.show:
            plt.show()
    else:
        render_frame(ax1, ax2, scene, graph_cfg, traj, poses_est,
                     frames_out, args.frames)
        save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
