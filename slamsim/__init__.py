"""slam-sim: a SLAM robot-simulation engine in JAX for the GPU.

Brand-new framework with the capabilities of the reference Python simulator
takuyani/SLAM-Robot_Simu (see SURVEY.md): velocity motion model, sector-FOV
landmark scan sensor, EKF localization, particle-filter localization, and
graph-based SLAM - redesigned as pure jitted step functions over pytree
state, vmapped/sharded over device meshes, with a Pallas kernel on the
hottest path.

Layer map (mirrors SURVEY.md section 1):
    core/      L0 math (angle wrap, SE(2), chi2, error ellipse)
    models/    L1 physical models (motion, process, observation, scan)
    filters/   L2 estimators (EKF, PF)
    slam/      L2 graph-based SLAM (edges, information matrix, Gauss-Newton)
    ops/       the fused EKF rollout kernel (Pallas through Triton) and
               its counter-based generator
    parallel/  device meshes, shard_map rollout sweeps, collectives
    sim/       scene configs and lax.scan drivers
    metrics/   RMSE / NEES / ESS device-side metric buffers
    viz/       host-side renderers + demo entry points (L3)
    utils/     config pytrees, checkpointing, profiling
"""

__version__ = "0.1.0"

from slamsim import core, filters, models

__all__ = ["core", "models", "filters", "__version__"]
