"""L0 math utilities: angle wrap, SE(2) transforms, chi2, error ellipse."""

from slamsim.core.angles import wrap_angle, wrap_angle_fast
from slamsim.core.chi2 import chi2_ppf_2dof, chi2_ppf_2dof_table
from slamsim.core.ellipse import error_ellipse, major_axis_length
from slamsim.core.se2 import BASE_ANG, robot_to_world, world_to_robot

__all__ = [
    "wrap_angle",
    "wrap_angle_fast",
    "chi2_ppf_2dof",
    "chi2_ppf_2dof_table",
    "error_ellipse",
    "major_axis_length",
    "BASE_ANG",
    "robot_to_world",
    "world_to_robot",
]
