"""Differential validation against the LIVE reference code.

Every other parity test in this suite compares slamsim against the float64
NumPy oracles in tests/oracles.py - hand re-derivations of the reference
algorithms.  A mis-derivation would make the oracle and the implementation
wrong in the same way and those tests would still pass.  This file closes
that loop: it imports and EXECUTES the modules under ``/root/reference``
(shimming the two removed third-party APIs they rely on), records every
``np.random`` draw they consume, replays the identical draws into the
slamsim implementations under float64, and asserts the trajectories agree.

Shims (nothing in the reference's own code is altered):
  * ``matplotlib.mlab.bivariate_normal`` - removed from matplotlib >= 3.1;
    the reference calls it at particle_filter.py:191.  Re-provided with the
    original closed form.
  * matplotlib backend forced to Agg (the reference imports pyplot at
    module level).
  * bytecode writing disabled during import (the reference tree is
    read-only).

All replays run with jax_enable_x64 so both sides compute in float64 and
tolerances can be tight (1e-8-ish over full multi-step runs); the f32
behavior of the package is covered by the oracle-based tests.
"""

import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REF_DIR = pathlib.Path("/root/reference")

pytestmark = pytest.mark.skipif(not REF_DIR.exists(),
                                reason="reference tree not present")


# ---------------------------------------------------------------------------
# Reference import machinery
# ---------------------------------------------------------------------------

class RefModules:
    """Namespace holding the imported live reference modules."""

    def __init__(self, ekf, pf, gbs, mm, limit, transform, error_ellipse):
        self.ekf = ekf
        self.pf = pf
        self.gbs = gbs
        self.mm = mm
        self.limit = limit
        self.transform = transform
        self.error_ellipse = error_ellipse


def _mlab_bivariate_normal(X, Y, sigmax=1.0, sigmay=1.0, mux=0.0, muy=0.0,
                           sigmaxy=0.0):
    """The original ``matplotlib.mlab.bivariate_normal`` closed form
    (removed in matplotlib 3.1; the reference calls it with
    ``sigmaxy = sqrt(R[0][1]) = 0`` at particle_filter.py:179-191)."""
    Xmu = X - mux
    Ymu = Y - muy
    rho = sigmaxy / (sigmax * sigmay)
    z = (Xmu ** 2 / sigmax ** 2 + Ymu ** 2 / sigmay ** 2
         - 2 * rho * Xmu * Ymu / (sigmax * sigmay))
    denom = 2 * np.pi * sigmax * sigmay * np.sqrt(1 - rho ** 2)
    return np.exp(-z / (2 * (1 - rho ** 2))) / denom


@pytest.fixture(scope="module")
def ref():
    """Import the live reference modules (once per test module)."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.mlab as mlab
    if not hasattr(mlab, "bivariate_normal"):
        mlab.bivariate_normal = _mlab_bivariate_normal

    old_flag = sys.dont_write_bytecode
    sys.dont_write_bytecode = True  # the reference tree is read-only
    sys.path.insert(0, str(REF_DIR))
    try:
        import extended_kalman_filter as ekf_mod
        import graph_based_slam as gbs_mod
        import motion_model as mm_mod
        import particle_filter as pf_mod
        from mylib import error_ellipse as ee_mod
        from mylib import limit as limit_mod
        from mylib import transform as tf_mod
    finally:
        sys.path.remove(str(REF_DIR))
        sys.dont_write_bytecode = old_flag
    return RefModules(ekf_mod, pf_mod, gbs_mod, mm_mod, limit_mod, tf_mod,
                      ee_mod)


@pytest.fixture
def x64():
    """Run the test body with float64 enabled; restore afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


class NoiseTap:
    """Replaces ``np.random.*`` with a private seeded stream, recording
    every draw so it can be replayed into the slamsim implementations."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.log = []  # (kind, *params, value)

    def install(self, monkeypatch):
        monkeypatch.setattr(np.random, "multivariate_normal", self._mvn)
        monkeypatch.setattr(np.random, "rand", self._rand)
        monkeypatch.setattr(np.random, "normal", self._normal)

    def _mvn(self, mean, cov, size=None):
        v = self.rs.multivariate_normal(mean, cov, size)
        self.log.append(("mvn", v))
        return v

    def _rand(self, *shape):
        v = self.rs.rand(*shape)
        self.log.append(("rand", v))
        return v

    def _normal(self, loc=0.0, scale=1.0, size=None):
        v = self.rs.normal(loc, scale, size)
        self.log.append(("normal", loc, scale, v))
        return v


def _unit(entry):
    """Recover the standard-normal unit draw from a recorded
    ``normal(loc, scale)`` entry."""
    kind, loc, scale, v = entry
    assert kind == "normal"
    return (v - loc) / scale


# ---------------------------------------------------------------------------
# EKF: trajectory + covariance exactness given identical draws
# ---------------------------------------------------------------------------

class TestEkfAgainstLiveReference:

    N_STEPS = 120

    def _run_reference(self, ref, monkeypatch, seed=1234):
        tap = NoiseTap(seed)
        tap.install(monkeypatch)
        rekf = ref.ekf.ExtendedKalmanFilter(100)
        outs, draws = [], []
        for _ in range(self.N_STEPS):
            n0 = len(tap.log)
            x_true, x_dr, z, x_pre, P = rekf.main_ekf()
            x_hat = rekf._ExtendedKalmanFilter__x_hat
            step_draws = tap.log[n0:]
            # main_ekf consumes exactly two draws: obs mvn (:100), dr mvn
            # (:105), in that order.
            assert [d[0] for d in step_draws] == ["mvn", "mvn"]
            w = step_draws[0][1][0]  # (2,)
            v = step_draws[1][1][0]  # (3,)
            draws.append((w, v))
            outs.append((x_true.ravel().copy(), x_dr.ravel().copy(),
                         z.ravel().copy(), x_pre.ravel().copy(),
                         x_hat.ravel().copy(), P.copy()))
        return outs, draws

    def test_trajectory_matches(self, ref, monkeypatch, x64):
        from slamsim.filters import EkfConfig, ekf_init, ekf_step_with_noise

        outs, draws = self._run_reference(ref, monkeypatch)
        cfg = EkfConfig()
        state = ekf_init(cfg)
        assert state.x_true.dtype == jnp.float64
        step = jax.jit(ekf_step_with_noise, static_argnums=0)
        for i, (w, v) in enumerate(draws):
            state, out = step(cfg, state, jnp.asarray(w), jnp.asarray(v))
            rxt, rxdr, rz, rxpre, rxhat, rP = outs[i]
            np.testing.assert_allclose(np.asarray(out.x_true), rxt,
                                       atol=1e-9, err_msg=f"step {i} x_true")
            np.testing.assert_allclose(np.asarray(out.x_dr), rxdr,
                                       atol=1e-9, err_msg=f"step {i} x_dr")
            np.testing.assert_allclose(np.asarray(out.z), rz, atol=1e-9,
                                       err_msg=f"step {i} z")
            np.testing.assert_allclose(np.asarray(out.x_pre), rxpre,
                                       atol=1e-8, err_msg=f"step {i} x_pre")
            np.testing.assert_allclose(np.asarray(state.x_hat), rxhat,
                                       atol=1e-8, err_msg=f"step {i} x_hat")
            np.testing.assert_allclose(np.asarray(state.cov), rP, atol=1e-10,
                                       err_msg=f"step {i} P")

    def test_oracle_agrees_with_reference(self, ref, monkeypatch):
        """Cross-check tests/oracles.py::ekf_step against the live code -
        the oracle every f32 parity test in test_ekf.py leans on."""
        import oracles

        outs, draws = self._run_reference(ref, monkeypatch, seed=77)
        dt, v_cmd, w_cmd = 0.1, 10.0 * np.deg2rad(10.0), np.deg2rad(10.0)
        Q = np.diag([0.1, 0.1, np.deg2rad(0.1)]) ** 2
        R = np.diag([1.0, 1.0]) ** 2
        x_true = x_dr = x_hat = np.array([10.0, 0.0, np.pi / 2])
        P = np.diag([0.01, 0.01, np.deg2rad(30.0)]) ** 2
        for i, (w, v) in enumerate(draws):
            x_true, x_dr, z, x_pre, x_hat, P = oracles.ekf_step(
                x_true, x_dr, x_hat, P, v_cmd, w_cmd, dt, Q, R, w, v)
            rxt, rxdr, rz, rxpre, rxhat, rP = outs[i]
            np.testing.assert_allclose(x_true, rxt, atol=1e-12)
            np.testing.assert_allclose(x_dr, rxdr, atol=1e-12)
            np.testing.assert_allclose(z, rz, atol=1e-12)
            np.testing.assert_allclose(x_pre, rxpre, atol=1e-12)
            np.testing.assert_allclose(x_hat, rxhat, atol=1e-11)
            np.testing.assert_allclose(P, rP, atol=1e-12)


# ---------------------------------------------------------------------------
# Motion model + scan sensor: one-step replay
# ---------------------------------------------------------------------------

class TestModelsAgainstLiveReference:

    def test_motion_model_matches(self, ref, monkeypatch, x64):
        from slamsim.models import MotionConfig, motion_mean, \
            motion_sample_with_noise

        tap = NoiseTap(7)
        tap.install(monkeypatch)
        model = ref.mm.MotionModel(2.0, 0.1, 0.2, 0.3, 0.1, 0.05, 0.15)
        cfg = MotionConfig(dt=2.0, a1=0.1, a2=0.2, a3=0.3, a4=0.1, a5=0.05,
                           a6=0.15)
        pose = np.array([[1.0], [2.0], [0.5]])
        for v_cmd, w_cmd in [(1.745, 0.1745), (0.5, -0.3), (2.0, 0.05)]:
            n0 = len(tap.log)
            ref_noisy = model.moveWithNoise(pose, v_cmd, w_cmd)
            ref_clean = model.moveWithoutNoise(pose, v_cmd, w_cmd)
            step_draws = tap.log[n0:]
            # moveWithNoise consumes three normal(0, sigma**2) draws
            # (motion_model.py:46-48).
            assert [d[0] for d in step_draws] == ["normal"] * 3
            units = np.array([_unit(d) for d in step_draws])
            got = motion_sample_with_noise(cfg, jnp.asarray(pose.ravel()),
                                           v_cmd, w_cmd, jnp.asarray(units))
            np.testing.assert_allclose(np.asarray(got),
                                       np.asarray(ref_noisy).ravel(),
                                       atol=1e-12)
            got_clean = motion_mean(cfg, jnp.asarray(pose.ravel()), v_cmd,
                                    w_cmd)
            np.testing.assert_allclose(np.asarray(got_clean),
                                       np.asarray(ref_clean).ravel(),
                                       atol=1e-12)
            pose = np.asarray(ref_noisy)

    def test_scan_sensor_matches(self, ref, monkeypatch, x64):
        from slamsim.models import ScanConfig, scan_apply_noise, scan_true

        tap = NoiseTap(11)
        tap.install(monkeypatch)
        landmarks = np.asarray(ref.gbs.LAND_MARKS, float)
        sensor = ref.gbs.ScanSensor(15.0, np.deg2rad(80.0), landmarks)
        sensor.setNoiseParam(5, 2, 2)
        cfg = ScanConfig(range_m=15.0, angle_rad=np.deg2rad(80.0),
                         dist_gain=0.05, dir_sigma=np.deg2rad(2.0),
                         orient_sigma=np.deg2rad(2.0))
        for pose_v in [(10.0, 0.0, np.pi / 2), (0.0, 3.0, 0.3),
                       (-4.0, -8.0, -2.0)]:
            pose_col = np.array(pose_v, float).reshape(3, 1)
            n0 = len(tap.log)
            obs_noisy, obs_true = sensor.scan(pose_col)
            step_draws = tap.log[n0:]

            true = scan_true(cfg, jnp.asarray(pose_v), jnp.asarray(landmarks))
            valid = np.asarray(true.valid)
            # Same detections, in landmark order.
            assert [o.getLandMarkId() for o in obs_true] == \
                list(np.nonzero(valid)[0])
            # Noise-free geometry matches.  The reference stores the RAW
            # (unwrapped) ``BASE_ANG - yaw`` in its noise-free orient
            # (graph_based_slam.py:153 - only the noisy draw passes through
            # limit_angle at :166); ours is wrapped.  All downstream use is
            # wrap-invariant, so compare modulo 2*pi.
            for o in obs_true:
                i = o.getLandMarkId()
                np.testing.assert_allclose(float(true.dist[i]), o.getDist(),
                                           atol=1e-12)
                np.testing.assert_allclose(float(true.bearing[i]), o.getDir(),
                                           atol=1e-12)
                d_orient = float(true.orient[i]) - o.getOrient()
                np.testing.assert_allclose(
                    np.arctan2(np.sin(d_orient), np.cos(d_orient)), 0.0,
                    atol=1e-12)
            # Replay the three-per-detection unit draws through our noise
            # law (dist, bearing, orient per detected landmark, in order;
            # graph_based_slam.py:164-167).
            assert len(step_draws) == 3 * len(obs_noisy)
            units = np.zeros((len(landmarks), 3))
            for j, o in enumerate(obs_noisy):
                for k in range(3):
                    units[o.getLandMarkId(), k] = _unit(step_draws[3 * j + k])
            noisy = scan_apply_noise(cfg, true, jnp.asarray(units))
            for o in obs_noisy:
                i = o.getLandMarkId()
                np.testing.assert_allclose(float(noisy.dist[i]), o.getDist(),
                                           atol=1e-12)
                np.testing.assert_allclose(float(noisy.bearing[i]),
                                           o.getDir(), atol=1e-12)
                d_or = float(noisy.orient[i]) - o.getOrient()
                np.testing.assert_allclose(
                    np.arctan2(np.sin(d_or), np.cos(d_or)), 0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# Particle filter: full replay of main_pf
# ---------------------------------------------------------------------------

class TestPfAgainstLiveReference:

    N_STEPS = 60

    def test_trajectory_matches(self, ref, monkeypatch, x64):
        from slamsim.filters import PfConfig, pf_init, pf_step_with_noise

        tap = NoiseTap(5)
        tap.install(monkeypatch)
        rpf = ref.pf.ParticleFilter(100)
        records = []
        for _ in range(self.N_STEPS):
            n0 = len(tap.log)
            lm, x_true, x_est, px, Q, max_idx, max_w = rpf.main_pf()
            step_draws = tap.log[n0:]
            kinds = [d[0] for d in step_draws]
            # Draw order in main_pf: optional resample rand (:214), predict
            # mvn (:165), observation mvn (:152).
            if kinds == ["rand", "mvn", "mvn"]:
                offs = float(step_draws[0][1])
                pred = step_draws[1][1]  # (NP, 3)
                obsn = step_draws[2][1]  # (L, 2)
                resampled = True
            else:
                assert kinds == ["mvn", "mvn"]
                offs, resampled = 0.0, False
                pred = step_draws[0][1]
                obsn = step_draws[1][1]
            pw = rpf._ParticleFilter__pw.ravel().copy()
            records.append((offs, pred, obsn, resampled,
                            x_true.ravel().copy(), x_est.ravel().copy(),
                            px.T.copy(), pw, int(max_idx), float(max_w)))

        cfg = PfConfig()
        state = pf_init(cfg)
        assert state.particles.dtype == jnp.float64
        step = jax.jit(pf_step_with_noise, static_argnums=0)
        for i, (offs, pred, obsn, resampled, rxt, rxe, rpx, rpw, rmi,
                rmw) in enumerate(records):
            state, out = step(cfg, state, jnp.asarray(offs),
                              jnp.asarray(pred), jnp.asarray(obsn))
            assert bool(out.resampled) == resampled, f"step {i} gate"
            np.testing.assert_allclose(np.asarray(out.x_true), rxt,
                                       atol=1e-10, err_msg=f"step {i} truth")
            np.testing.assert_allclose(np.asarray(out.particles), rpx,
                                       atol=1e-9,
                                       err_msg=f"step {i} particles")
            np.testing.assert_allclose(np.asarray(out.weights), rpw,
                                       atol=1e-12, err_msg=f"step {i} w")
            assert int(out.max_idx) == rmi, f"step {i} MAP index"
            np.testing.assert_allclose(float(out.max_w), rmw, atol=1e-12)
            np.testing.assert_allclose(np.asarray(out.x_est), rxe,
                                       atol=1e-9, err_msg=f"step {i} x_est")


# ---------------------------------------------------------------------------
# mylib: live checks of error_ellipse / limit / transform
# ---------------------------------------------------------------------------

class TestMylibAgainstLiveReference:
    """Direct differential tests of the one reference package that the
    replay tests above import but never execute: ``mylib``.  Random inputs
    through the LIVE classes/functions vs the slamsim twins, float64."""

    def test_chi2_table_matches_reference_grid(self, ref, x64):
        """Our closed-form-regenerated chi-squared grid must equal the
        reference's hardcoded 43-entry table (error_ellipse.py:24-36) to
        its printed precision, and the interpolant must agree everywhere."""
        from slamsim.core.chi2 import CHI2_GRID, P_GRID, chi2_ppf_2dof_table

        ee = ref.error_ellipse.ErrorEllipse(99.0)
        np.testing.assert_allclose(np.asarray(CHI2_GRID), ee.square_x,
                                   rtol=0, atol=5e-9)
        np.testing.assert_allclose(np.asarray(P_GRID), ee.p, atol=0)
        rng = np.random.RandomState(0)
        ps = np.concatenate([rng.uniform(0.0, 99.9, 64), ee.p])
        for p in ps:
            np.testing.assert_allclose(
                float(chi2_ppf_2dof_table(p)),
                float(ee.chi_squared_distribution(p)), rtol=1e-7,
                atol=1e-9, err_msg=f"p={p}")

    def test_error_ellipse_matches(self, ref, x64):
        """Random PSD covariances through the LIVE
        ``ErrorEllipse.calc_error_ellipse`` (error_ellipse.py:39-55) vs
        ``core/ellipse.py::error_ellipse(row_eigvec_compat=True)``.

        The ellipse angle is compared modulo pi: eigh's eigenvector SIGN is
        convention-dependent (LAPACK vs XLA may negate), and an ellipse at
        ang and ang+pi is the same ellipse (the reference only feeds it to
        matplotlib's patch angle)."""
        from slamsim.core.ellipse import error_ellipse, major_axis_length

        rng = np.random.RandomState(3)
        for p in (99.9, 99.0, 95.0, 80.0, 42.5, 7.3):
            ee = ref.error_ellipse.ErrorEllipse(p)
            for _ in range(16):
                a = rng.randn(2, 2)
                sigma = a @ a.T + 1e-3 * np.eye(2)
                rl, ry, rang = ee.calc_error_ellipse(sigma)
                gl, gy, gang = error_ellipse(jnp.asarray(sigma), p,
                                             row_eigvec_compat=True)
                # The reference's chi2 table carries ~10 printed digits,
                # so lengths agree to ~1e-8 relative, not machine epsilon.
                np.testing.assert_allclose(float(gl), rl, rtol=1e-7,
                                           err_msg=f"major p={p}")
                np.testing.assert_allclose(float(gy), ry, rtol=1e-7,
                                           err_msg=f"minor p={p}")
                d = float(gang) - rang
                np.testing.assert_allclose(np.sin(d) * np.cos(d), 0.0,
                                           atol=1e-12,
                                           err_msg=f"angle p={p}")
                # calc_chi (error_ellipse.py:57-68): major axis at another p.
                p2 = float(rng.uniform(0.5, 99.5))
                np.testing.assert_allclose(
                    float(major_axis_length(jnp.asarray(sigma), p2)),
                    ee.calc_chi(p2, sigma), rtol=1e-7,
                    err_msg=f"calc_chi p2={p2}")

    def test_limit_angle_matches(self, ref, x64):
        from slamsim.core.angles import wrap_angle

        rng = np.random.RandomState(5)
        angles = np.concatenate([
            rng.uniform(-20.0, 20.0, 256),         # incl. |a| > 3*pi
            rng.uniform(-np.pi, np.pi, 64),
            [0.0, np.pi, -np.pi, 2 * np.pi, -2 * np.pi, 3.5 * np.pi],
        ])
        got = np.asarray(wrap_angle(jnp.asarray(angles)))
        for a, g in zip(angles, got):
            np.testing.assert_allclose(g, ref.limit.limit_angle(a),
                                       atol=1e-12, err_msg=f"angle {a}")

    def test_transform_matches(self, ref, x64):
        from slamsim.core.se2 import robot_to_world, world_to_robot

        rng = np.random.RandomState(9)
        for _ in range(8):
            origin = rng.uniform(-10, 10, (3, 1))
            pts = rng.uniform(-20, 20, (5, 2))
            ref_r = ref.transform.world2robot(origin, pts)
            got_r = world_to_robot(jnp.asarray(origin.ravel()),
                                   jnp.asarray(pts))
            np.testing.assert_allclose(np.asarray(got_r), ref_r, atol=1e-12)
            ref_w = ref.transform.robot2world(origin, pts)
            got_w = robot_to_world(jnp.asarray(origin.ravel()),
                                   jnp.asarray(pts))
            np.testing.assert_allclose(np.asarray(got_w), ref_w, atol=1e-12)


# ---------------------------------------------------------------------------
# Graph SLAM: frame-for-frame parity on the demo course
# ---------------------------------------------------------------------------

class TestGraphSlamAgainstLiveReference:

    @pytest.mark.slow
    def test_course_matches_frame_for_frame(self, ref, x64):
        """The full 18-frame reference demo course (slow tier)."""
        self._run_course(ref, 18)

    def test_course_matches_fast(self, ref, x64):
        """6-frame prefix of the same course - runs in the smoke tier so
        CI always gates on live graph parity."""
        self._run_course(ref, 6)

    def _run_course(self, ref, n_frames):
        from slamsim.slam.graph import (GraphConfig, GraphObservations,
                                        graph_solve)

        gbs = ref.gbs
        np.random.seed(42)
        landmarks = np.asarray(gbs.LAND_MARKS, float)
        x_base = np.array([[10.0], [0.0], [np.deg2rad(90.0)]])
        rbt = gbs.Robot(x_base, 2.0, gbs.SCN_SENS_RANGE_m,
                        gbs.SCN_SENS_ANGLE_rps, landmarks)
        vel, omg = gbs.VEL_mps, gbs.OMEGA_rps

        t1 = n_frames + 1
        n_lm = len(landmarks)
        cfg = GraphConfig(max_times=t1, num_landmarks=n_lm)
        solve = jax.jit(graph_solve, static_argnums=(0,),
                        static_argnames=("t_now",))

        def obs_tensors():
            # Masked slots must hold a non-degenerate distance: the edge
            # builder inverts the (masked) 3x3 covariance before applying
            # the mask, and dist=0 makes it singular (0 * inf = NaN).  The
            # real pipeline keeps the geometric truth in masked slots
            # (models/scan_sensor.py::Scan docstring).
            dist = np.ones((t1, n_lm))
            bearing = np.zeros((t1, n_lm))
            orient = np.zeros((t1, n_lm))
            valid = np.zeros((t1, n_lm), bool)
            for he in rbt._Robot__mHalfEdges:
                t, o = he.getTime(), he.getObs()
                lm_id = o.getLandMarkId()
                dist[t, lm_id] = o.getDist()
                bearing[t, lm_id] = o.getDir()
                orient[t, lm_id] = o.getOrient()
                valid[t, lm_id] = True
            return GraphObservations(dist=jnp.asarray(dist),
                                     bearing=jnp.asarray(bearing),
                                     orient=jnp.asarray(orient),
                                     valid=jnp.asarray(valid))

        def est_poses():
            est = rbt._Robot__mTrjEst
            return np.array([p.ravel() for p in
                             est._TrajectoryEstimator__mPosesEst])

        for frame in range(1, n_frames + 1):
            rbt.move(vel, omg)
            obs = obs_tensors()
            poses_init = est_poses()  # (frame+1, 3): the pre-solve guesses
            pad = np.tile(poses_init[-1], (t1 - len(poses_init), 1))
            poses_pad = jnp.asarray(np.concatenate([poses_init, pad]))

            rbt.estimateOpticalTrajectory()
            ref_poses = est_poses()
            ref_iters = rbt._Robot__loopCnt
            ref_delta = rbt._Robot__deltaSum
            ref_det = rbt._Robot__det
            ref_cond = rbt._Robot__cond
            ref_calc = rbt._Robot__isCalc

            res = solve(cfg, poses_pad, obs, t_now=frame)
            got_poses = np.asarray(res.poses)[:frame + 1]
            np.testing.assert_allclose(
                got_poses, ref_poses, atol=5e-5,
                err_msg=f"frame {frame} poses")
            assert int(res.gn_iters) == ref_iters, (
                f"frame {frame}: GN iters {int(res.gn_iters)} != "
                f"{ref_iters}")
            assert bool(res.is_calc) == bool(ref_calc)
            np.testing.assert_allclose(float(res.delta_sum), ref_delta,
                                       rtol=1e-3, atol=1e-9,
                                       err_msg=f"frame {frame} delta")
            # det/cond of the padded H equal the compacted reference values
            # up to solver roundoff; compare in log space like test_graph.
            # graph_solve clips log-det at 80 (exp(88) overflows the f32
            # path it normally runs in), so compare against the clip.
            np.testing.assert_allclose(np.log(float(res.det)),
                                       min(np.log(ref_det), 80.0), rtol=1e-3,
                                       err_msg=f"frame {frame} det")
            np.testing.assert_allclose(np.log(float(res.cond)),
                                       np.log(ref_cond), rtol=0.05,
                                       err_msg=f"frame {frame} cond")
