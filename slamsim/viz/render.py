"""Host-side rendering primitives for the demo visualizations.

Capability parity with the reference's L3 drawing code (SURVEY.md
section 2, rows 14-18): trajectories as line+scatter, heading quivers,
confidence error ellipses, landmark stars, scan-sensor FOV arcs, particle
clouds.  The difference from the reference is architectural: these functions
consume device-resident ``(T, ...)`` buffers produced by ``lax.scan``
rollouts (one host transfer per rollout), instead of the reference's
per-frame ``plt.cla()`` + full re-plot of ever-growing Python lists
(extended_kalman_filter.py:231-273, the actual bottleneck of its demos).

Everything here is NumPy + matplotlib only - no jax imports - so rendering
runs on the host while the device is free.
"""

from __future__ import annotations

import math

import numpy as np
from matplotlib import patches

from slamsim.core.chi2 import CHI2_GRID as _CHI2_GRID
from slamsim.core.chi2 import P_GRID as _P_GRID

BASE_ANG = math.pi / 2.0


def _chi2_table(p_percent: float) -> float:
    return float(np.interp(p_percent, np.asarray(_P_GRID[::-1]),
                           np.asarray(_CHI2_GRID[::-1])))


def ellipse_params(cov2, p_percent=99.0, row_eigvec_compat=True):
    """(major, minor, angle_deg) of the p% ellipse of a 2x2 covariance.

    Host-side twin of :func:`slamsim.core.ellipse.error_ellipse` (parity:
    mylib/error_ellipse.py:39-55, incl. the row-eigenvector quirk).
    """
    chi2 = _chi2_table(p_percent)
    val, vec = np.linalg.eigh(np.asarray(cov2))
    vmax = vec[1] if row_eigvec_compat else vec[:, 1]
    ang = math.degrees(math.atan2(vmax[1], vmax[0]))
    return (2.0 * math.sqrt(val[1] * chi2), 2.0 * math.sqrt(val[0] * chi2),
            ang)


def draw_error_ellipse(ax, center, cov2, p_percent=99.0, label=""):
    """Add a p%-confidence ellipse patch (yellow/black, alpha 0.2 - the
    reference's styling, extended_kalman_filter.py:261-263)."""
    major, minor, ang = ellipse_params(cov2, p_percent)
    e = patches.Ellipse(tuple(np.asarray(center)[:2]), major, minor,
                        angle=ang, linewidth=2, alpha=0.2,
                        facecolor="yellow", edgecolor="black", label=label)
    ax.add_patch(e)
    return e


def draw_trajectory(ax, poses, color, label=None, marker_last=True):
    """Polyline of ``(T, >=2)`` poses with optional current-point marker."""
    poses = np.asarray(poses)
    ax.plot(poses[:, 0], poses[:, 1], c=color, linewidth=1.0,
            linestyle="-", label=label)
    if marker_last and len(poses):
        ax.scatter(poses[-1, 0], poses[-1, 1], c=color, marker="o",
                   alpha=0.5)


def draw_poses_quiver(ax, poses, color, label=None):
    """Heading arrows at each pose (graph_based_slam.py:756-778 styling)."""
    poses = np.asarray(poses)
    ax.quiver(poses[:, 0], poses[:, 1], np.cos(poses[:, 2]),
              np.sin(poses[:, 2]), color=color, angles="xy",
              scale_units="xy", scale=1)
    ax.plot(poses[:, 0], poses[:, 1], c=color, linewidth=1.0,
            linestyle="-", label=label)


def draw_landmarks(ax, landmarks, color="yellow", edge="orange",
                   label="Land Mark"):
    """Landmark stars (particle_filter.py:264-267 styling)."""
    lm = np.asarray(landmarks)
    ax.scatter(lm[:, 0], lm[:, 1], s=100, c=color, marker="*", alpha=0.5,
               linewidths=2, edgecolors=edge, label=label)


def draw_particles(ax, particles, quiver=False):
    """Particle cloud (particle_filter.py:278-281 styling)."""
    p = np.asarray(particles)
    ax.scatter(p[:, 0], p[:, 1], c="cyan", marker="o", alpha=0.5)
    if quiver:
        ax.quiver(p[:, 0], p[:, 1], np.cos(p[:, 2]), np.sin(p[:, 2]),
                  color="cyan", units="inches", scale=6.0, width=0.01,
                  headwidth=0.0, headlength=0.0, headaxislength=0.0)


def fov_arc_points(range_m, angle_rad, step_deg=1.0):
    """Sector-outline polygon in the robot frame.

    Parity: the arc the reference precomputes in ScanSensor.__init__
    (graph_based_slam.py:99-112): points every ``step_deg`` across the
    sector about +y, closed through the origin.
    """
    ang = math.degrees(angle_rad)
    ofs = math.degrees(BASE_ANG)
    degs = np.arange(-ang + ofs, ang + ofs + step_deg, step_deg)
    xs = range_m * np.cos(np.deg2rad(degs))
    ys = range_m * np.sin(np.deg2rad(degs))
    xs = np.concatenate([xs, [0.0, xs[0]]])
    ys = np.concatenate([ys, [0.0, ys[0]]])
    return np.stack([xs, ys], axis=1)


def draw_fov(ax, pose, range_m, angle_rad, color="green"):
    """Draw the scan sector at a world pose (graph_based_slam.py:236-247)."""
    pose = np.asarray(pose)
    pts = fov_arc_points(range_m, angle_rad)
    yaw = pose[2] - BASE_ANG
    c, s = math.cos(yaw), math.sin(yaw)
    world = np.stack([c * pts[:, 0] - s * pts[:, 1] + pose[0],
                      s * pts[:, 0] + c * pts[:, 1] + pose[1]], axis=1)
    ax.plot(world[:, 0], world[:, 1], c=color, linewidth=1.0,
            linestyle="-")


def finalize_axes(ax, title, equal=True):
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    if equal:
        ax.axis("equal")
    ax.grid(True)
    ax.legend(fontsize=10)


def save_or_show(fig, save: str | None, show: bool):
    import matplotlib.pyplot as plt

    if save:
        fig.savefig(save, dpi=110, bbox_inches="tight")
        print(f"saved {save}")
    if show:
        plt.show()
    else:
        plt.close(fig)


def save_animation(ani, path: str, fps: int):
    """Save an animation, picking the writer from the file extension.

    ``.mp4`` uses the ffmpeg writer — parity with the reference's
    documented mp4 export (/root/reference/README.md:65-79 and the
    commented ``anime.save('*.mp4')`` calls, e.g.
    extended_kalman_filter.py:289) — anything else uses pillow (gif).
    """
    if path.endswith(".mp4"):
        from matplotlib import animation

        if not animation.FFMpegWriter.isAvailable():
            raise RuntimeError(
                "mp4 export needs ffmpeg on PATH (see the reference "
                "README's ffmpeg setup); use a .gif path for pillow")
        ani.save(path, writer="ffmpeg", fps=fps)
    else:
        ani.save(path, writer="pillow", fps=fps)
    print(f"saved {path}")
