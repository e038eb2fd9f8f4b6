"""Graph-SLAM simulation frontend: the reference ``Robot`` as pure scans.

Capability parity with ``Robot`` (graph_based_slam.py:584-896) minus the
drawing (which lives in ``slamsim.viz``): drive the ground-truth pose with
the noisy velocity motion model, keep a one-step noiseless odometry estimate
as the graph's initial guess, scan landmarks at the actual pose each step,
and (each frame) run the Gauss-Newton trajectory estimator over everything
observed so far.

Reference subtleties reproduced:
  * The odometry guess for time t is ONE noiseless step from the previous
    *actual* pose (graph_based_slam.py:647-648,656), not a chained
    dead-reckoning trajectory.
  * Time 0 contributes a scan from the exact start pose
    (graph_based_slam.py:625-626), and the estimator's pose 0 is the exact
    start pose.
  * Estimated poses persist across frames: the GN update at frame t only
    touches times <= t, and time t enters with its odometry value.

Device shape: :func:`simulate` is one ``lax.scan`` producing padded
``(T1, ...)`` trajectory + observation tensors;
:func:`slam_rollout` is a second scan over frames whose body is the jitted
:func:`~slamsim.slam.graph.graph_solve` with a growing ``t_now`` mask -
one compiled solve serves all frames.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import jax
import jax.numpy as jnp

from slamsim.models.motion import MotionConfig, motion_mean, motion_sample
from slamsim.models.scan_sensor import scan as sensor_scan
from slamsim.slam.graph import (GraphConfig, GraphObservations,
                                GraphSolveResult, graph_solve)

#: Reference demo landmark table (graph_based_slam.py:910-918).
REF_SLAM_LANDMARKS = ((0.0, 0.0), (14.0, 1.0), (9.0, 9.0), (0.0, 15.0),
                      (-11.0, 10.0), (-14.0, 1.0), (-10.0, -9.0),
                      (0.0, -16.0), (10.0, -11.0))


@dataclasses.dataclass(frozen=True)
class SlamSceneConfig:
    """Static scenario config; defaults = reference demo
    (graph_based_slam.py:900-927)."""

    landmarks: tuple = REF_SLAM_LANDMARKS
    dt: float = 2.0  # PERIOD_ms = 2000 (:921)
    radius_m: float = 10.0  # (:903)
    yaw_rate: float = math.radians(10.0)  # OMEGA_rps (:906)
    x0: tuple = (10.0, 0.0, math.pi / 2.0)  # x_base (:923-925)
    motion: MotionConfig = MotionConfig(dt=2.0)  # a1..a6 = 0.1 (:605)

    @property
    def vel(self) -> float:
        return self.radius_m * self.yaw_rate  # VEL_mps (:907)


class SlamTrajectory(typing.NamedTuple):
    """Padded simulation results; row t = time t (row 0 = start)."""

    poses_actu: jax.Array  # (T1, 3) ground truth (moveWithNoise chain)
    poses_odom: jax.Array  # (T1, 3) per-step noiseless odometry guesses
    obs: GraphObservations  # (T1, L) noisy sightings
    obs_true: GraphObservations  # (T1, L) noise-free sightings


def reference_course_config(n_steps: int, guard: str = "full",
                            **overrides) -> GraphConfig:
    """The :class:`GraphConfig` of the reference demo course.

    One construction shared by bench.py, the distributional-fixture
    generator, and tests: ``max_times = n_steps + 1`` over the 9 demo
    landmarks with the demo's scan noise (range 15 m / 80deg FOV, 5%
    range noise, 2deg bearing/orientation - graph_based_slam.py:604,
    900-927), full reference guards by default.
    """
    from slamsim.models.scan_sensor import ScanConfig

    kw = dict(
        max_times=n_steps + 1, num_landmarks=len(REF_SLAM_LANDMARKS),
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)),
        guard=guard)
    kw.update(overrides)
    return GraphConfig(**kw)


def simulate(scene: SlamSceneConfig, graph_cfg: GraphConfig, key,
             n_steps: int, controls=None) -> SlamTrajectory:
    """Simulate ``n_steps`` frames of robot motion + scanning.

    Parity: the sim half of ``Robot.move`` + ``Robot.__observe``
    (graph_based_slam.py:638-682).  Returns padded ``(n_steps+1, ...)``
    tensors; row 0 is the exact start pose and its scan.

    Args:
        controls: optional ``(n_steps, 2)`` per-step ``(v, w)`` commands -
            the reference's ``Robot.move(v, w)`` takes arbitrary controls
            per call (graph_based_slam.py:638); default = the demo's
            constant circle ``(scene.vel, scene.yaw_rate)``
            (graph_based_slam.py:941).
    """
    lm = jnp.asarray(scene.landmarks)
    x0 = jnp.asarray(scene.x0)
    k0, kscan = jax.random.split(key)
    obs0_noisy, obs0_true = sensor_scan(graph_cfg.scan, kscan, x0, lm)
    if controls is None:
        controls = jnp.tile(
            jnp.asarray([(scene.vel, scene.yaw_rate)], jnp.float32),
            (n_steps, 1))
    else:
        controls = jnp.asarray(controls, jnp.float32)
        if controls.shape != (n_steps, 2):
            raise ValueError(
                f"controls shape {controls.shape} != ({n_steps}, 2)")

    def body(pose_actu, kc):
        k, (v, w) = kc
        k_mv, k_sc = jax.random.split(k)
        pose_next = motion_sample(scene.motion, k_mv, pose_actu, v, w)
        pose_odom = motion_mean(scene.motion, pose_actu, v, w)
        noisy, true = sensor_scan(graph_cfg.scan, k_sc, pose_next, lm)
        return pose_next, (pose_next, pose_odom, noisy, true)

    keys = jax.random.split(k0, n_steps)
    _, (actu, odom, noisy, true) = jax.lax.scan(
        body, x0, (keys, (controls[:, 0], controls[:, 1])))

    def cat(first, rest):
        return jnp.concatenate([first[None], rest], axis=0)

    poses_actu = cat(x0, actu)
    poses_odom = cat(x0, odom)
    obs = GraphObservations(*[cat(a, b) for a, b in zip(obs0_noisy, noisy)])
    obs_true = GraphObservations(
        *[cat(a, b) for a, b in zip(obs0_true, true)])
    return SlamTrajectory(poses_actu=poses_actu, poses_odom=poses_odom,
                          obs=obs, obs_true=obs_true)


def observed_times_mask(obs: GraphObservations):
    """Boolean (T1,) of times whose scan detected at least one landmark.

    Parity: the reference's per-pose ``isObs`` flag — set by
    ``Robot.__observe`` iff any landmark was in the FOV
    (graph_based_slam.py:674-682), with pose 0 always flagged observed
    (graph_based_slam.py:343).  ``getEstTrajPose`` draws the estimated
    trajectory only at these times (graph_based_slam.py:441-449).
    """
    return jnp.any(obs.valid, axis=1).at[0].set(True)


def slam_rollout(scene: SlamSceneConfig, graph_cfg: GraphConfig, key,
                 n_steps: int, controls=None):
    """Full demo loop: simulate, then per-frame Gauss-Newton estimation.

    Parity: the ``graph_based_slam`` animation callback
    (graph_based_slam.py:931-975) - each frame moves the robot one step and
    re-estimates the whole trajectory from all sightings so far.

    Args:
        controls: optional ``(n_steps, 2)`` per-step ``(v, w)`` commands
            (see :func:`simulate`).

    Returns:
        ``(traj, poses_est, frames)`` where ``traj`` is the
        :class:`SlamTrajectory`, ``poses_est`` the final ``(T1, 3)``
        estimates, and ``frames`` a :class:`GraphSolveResult` with a
        leading per-frame axis (is_calc, gn_iters, delta_sum, det, cond
        for every frame, as the reference prints/renders per frame, plus
        the ``(n_steps, max_gn_iters)`` per-iteration traces backing the
        reference's per-loop "Loop(n)" printout).
    """
    traj = simulate(scene, graph_cfg, key, n_steps, controls=controls)

    def frame(poses_est, t):
        res = graph_solve(graph_cfg, poses_est, traj.obs, t_now=t)
        return res.poses, res._replace(poses=jnp.zeros((0,)))

    poses_est, frames = jax.lax.scan(
        frame, traj.poses_odom, jnp.arange(1, n_steps + 1))
    return traj, poses_est, frames


def solve_once(scene: SlamSceneConfig, graph_cfg: GraphConfig, key,
               n_steps: int, controls=None):
    """Simulate then run a single full-history solve (benchmark shape).

    This is the large-scale path (BASELINE config 5 uses it with a sparse
    solver): one Gauss-Newton solve over the complete trajectory.
    """
    traj = simulate(scene, graph_cfg, key, n_steps, controls=controls)
    res = graph_solve(graph_cfg, traj.poses_odom, traj.obs)
    return traj, res
