"""L3 visualization: host-side renderers + demo entry points.

Demos (mirroring the reference scripts 1:1, SURVEY.md section 2 rows
14-18)::

    python -m slamsim.viz.demo_ekf          # extended_kalman_filter.py
    python -m slamsim.viz.demo_pf           # particle_filter.py
    python -m slamsim.viz.demo_graph_slam   # graph_based_slam.py
    python -m slamsim.viz.demo_motion       # motion_model.py
    python -m slamsim.viz.demo_transform    # mylib/transform.py demo
    python -m slamsim.viz.demo_ellipse      # mylib/error_ellipse.py demo
    python -m slamsim.viz.demo_large_slam   # scaling tier (no ref analog)
"""

from slamsim.viz.render import (draw_error_ellipse, draw_fov,
                                draw_landmarks, draw_particles,
                                draw_poses_quiver, draw_trajectory,
                                ellipse_params, finalize_axes,
                                fov_arc_points, save_or_show)

__all__ = [
    "draw_error_ellipse", "draw_fov", "draw_landmarks", "draw_particles",
    "draw_poses_quiver", "draw_trajectory", "ellipse_params",
    "finalize_axes", "fov_arc_points", "save_or_show",
]
