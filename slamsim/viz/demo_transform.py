"""SE(2) transform round-trip demo: world -> robot -> world panels.

Parity with mylib/transform.py:61-131 (``__main__``): a fixed origin pose
and four world points, shown in the world frame, the robot frame, and
transformed back (visual check of the inverse property; the numeric
check lives in tests/test_core.py).

Run::

    python -m slamsim.viz.demo_transform --save transform.png
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from slamsim.viz.render import save_or_show


def _panel(ax, pts, origin_xy, heading, title, scale):
    ax.scatter(pts[:, 0], pts[:, 1], c="green", s=60, marker="o",
               alpha=0.5)
    ax.scatter([origin_xy[0]], [origin_xy[1]], c="red", s=60, marker="o",
               alpha=0.5)
    ax.quiver([origin_xy[0]], [origin_xy[1]], [heading[0]], [heading[1]],
              angles="xy", scale_units="xy", scale=1)
    for p in pts:
        ax.plot([origin_xy[0], p[0]], [origin_xy[1], p[1]], "--",
                c="green")
    ax.grid(True)
    ax.set_title(title, fontsize=12)
    ax.axis([origin_xy[0] - scale, origin_xy[0] + scale,
             origin_xy[1] - scale, origin_xy[1] + scale])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slamsim.core import robot_to_world, world_to_robot

    origin = jnp.array([1.0, 3.0, math.radians(-10.0)])
    world = jnp.array([[4.0, 4.0], [0.0, 0.0], [3.0, -1.0], [-3.0, -5.0]])
    local = world_to_robot(origin, world)
    world2 = robot_to_world(origin, local)

    scl = 10.0
    hx, hy = math.cos(float(origin[2])), math.sin(float(origin[2]))
    fig = plt.figure(figsize=(12, 6))
    ax1 = fig.add_subplot(1, 3, 1, aspect="equal")
    ax2 = fig.add_subplot(1, 3, 2, aspect="equal")
    ax3 = fig.add_subplot(1, 3, 3, aspect="equal")
    _panel(ax1, np.asarray(world), np.asarray(origin[:2]), (hx, hy),
           "World", scl)
    _panel(ax2, np.asarray(local), (0.0, 0.0), (0.0, 1.0), "Robot", scl)
    _panel(ax3, np.asarray(world2), np.asarray(origin[:2]), (hx, hy),
           "World2", scl)
    save_or_show(fig, args.save, args.show)


if __name__ == "__main__":
    main()
