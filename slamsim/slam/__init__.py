"""Graph-based SLAM: batched edge construction, information-matrix
assembly, Gauss-Newton solving, and the simulation frontend."""

from slamsim.slam.frontend import (REF_SLAM_LANDMARKS, SlamSceneConfig,
                                   SlamTrajectory, observed_times_mask,
                                   reference_course_config, simulate,
                                   slam_rollout, solve_once)
from slamsim.slam.graph import (GraphConfig, GraphObservations,
                                GraphSolveResult, assemble, build_edges,
                                gn_iteration, graph_solve, kept_times,
                                preconditioned_solve, upper_pairs)
from slamsim.slam.cyclic import banded_solve_cr, block_cr_solve
from slamsim.slam.large import (BandedSolveResult, EdgeList,
                                add_odometry_chain, assemble_banded,
                                banded_matvec, build_edge_blocks, cg_solve,
                                count_window_pairs, graph_solve_banded,
                                make_large_scene, window_pairs,
                                window_pairs_device)

__all__ = [
    "REF_SLAM_LANDMARKS", "SlamSceneConfig", "SlamTrajectory",
    "observed_times_mask", "reference_course_config", "simulate",
    "slam_rollout", "solve_once", "GraphConfig", "GraphObservations",
    "GraphSolveResult", "assemble", "build_edges", "gn_iteration",
    "graph_solve", "kept_times", "preconditioned_solve", "upper_pairs",
    "BandedSolveResult", "EdgeList", "add_odometry_chain",
    "assemble_banded", "banded_matvec", "build_edge_blocks", "cg_solve",
    "count_window_pairs", "graph_solve_banded", "make_large_scene",
    "window_pairs", "window_pairs_device", "banded_solve_cr",
    "block_cr_solve",
]
