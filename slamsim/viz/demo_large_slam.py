"""Large-scale graph-SLAM demo: odometry drift vs optimized trajectory.

No reference counterpart (the reference demo stops at 18 poses): this
shows the scaling tier - a long loop course with heavy odometry drift,
corrected by the windowed banded Gauss-Newton solver
(``slamsim.slam.large``).

Run::

    python -m slamsim.viz.demo_large_slam --poses 1000 --landmarks 100 \
        --save large.png
"""

from __future__ import annotations

import argparse
import math


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--poses", type=int, default=1000)
    ap.add_argument("--landmarks", type=int, default=100)
    ap.add_argument("--window", type=int, default=30)
    ap.add_argument("--odom-noise", type=float, default=0.2)
    ap.add_argument("--solver",
                    choices=["cg", "cholesky", "tridiag", "cr"],
                    default="cg")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import jax
    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slamsim.core.angles import wrap_angle
    from slamsim.models.scan_sensor import ScanConfig
    from slamsim.slam import (GraphConfig, graph_solve_banded,
                              make_large_scene, window_pairs)

    cfg = GraphConfig(
        max_times=args.poses, num_landmarks=args.landmarks,
        max_gn_iters=15,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)),
        exact_jacobians=True)
    radius = max(30.0, 0.3 * args.poses)
    pt, po, obs = make_large_scene(cfg, jax.random.key(args.seed),
                                   args.poses, args.landmarks,
                                   radius=radius,
                                   odom_noise=args.odom_noise)
    el = window_pairs(np.asarray(obs.valid), window=args.window)
    rel_odom = po[1:] - po[:-1]
    rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
    res = graph_solve_banded(
        cfg, po, obs, el, band=args.window, rel_odom=rel_odom,
        odom_info=(1 / args.odom_noise ** 2,) * 3, solver=args.solver)

    pt_np = np.asarray(pt)
    po_np = np.asarray(po)
    est = np.asarray(res.poses)
    rmse_o = np.sqrt(((po_np[:, :2] - pt_np[:, :2]) ** 2).sum(-1).mean())
    rmse_e = np.sqrt(((est[:, :2] - pt_np[:, :2]) ** 2).sum(-1).mean())
    print(f"edges={el.t_b.shape[0]} gn_iters={int(res.gn_iters)} "
          f"odometry RMSE={rmse_o:.2f} m -> optimized RMSE={rmse_e:.2f} m")

    fig, ax = plt.subplots(figsize=(12, 12))
    ax.plot(pt_np[:, 0], pt_np[:, 1], c="red", lw=1.5,
            label="Ground Truth")
    ax.plot(po_np[:, 0], po_np[:, 1], c="gray", lw=1.0, ls="--",
            label=f"Odometry (RMSE {rmse_o:.2f} m)")
    ax.plot(est[:, 0], est[:, 1], c="blue", lw=1.2,
            label=f"Graph-SLAM (RMSE {rmse_e:.2f} m)")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"Large-scale graph SLAM: {args.poses} poses, "
                 f"{args.landmarks} landmarks, {el.t_b.shape[0]} edges")
    ax.axis("equal")
    ax.grid(True)
    ax.legend(fontsize=10)

    from slamsim.viz.render import save_or_show

    save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
