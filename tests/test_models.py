"""Unit tests for slamsim.models (SURVEY.md section 4, item 1)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracles
from slamsim.models import (MotionConfig, ScanConfig, circular_jacobian,
                            circular_step, cov_measurement_to_robot,
                            cov_measurement_to_world, landmark_observation,
                            measurement_cov, motion_mean, motion_sample,
                            position_observation, scan, scan_true)


class TestCircularProcess:
    def test_step_matches_oracle(self, rng):
        x = rng.normal(size=3)
        v, w, dt = 1.745, np.deg2rad(10.0), 0.1
        got = np.asarray(circular_step(jnp.asarray(x), v, w, dt))
        np.testing.assert_allclose(got, oracles.circular_step(x, v, w, dt),
                                   atol=1e-5)

    def test_jacobian_matches_autodiff(self, rng):
        x = jnp.asarray(rng.normal(size=3))
        v, w, dt = 1.745, np.deg2rad(10.0), 0.1
        jac = np.asarray(circular_jacobian(x, v, dt))
        # Away from the wrap boundary, autodiff of the step equals the
        # analytic Jacobian (extended_kalman_filter.py:180-194).
        auto = np.asarray(jax.jacfwd(
            lambda s: circular_step(s, v, w, dt))(x))
        np.testing.assert_allclose(jac, auto, atol=1e-5)

    def test_batched(self, rng):
        xs = jnp.asarray(rng.normal(size=(100, 3)))
        out = circular_step(xs, 1.0, 0.2, 0.1)
        assert out.shape == (100, 3)
        jac = circular_jacobian(xs, 1.0, 0.1)
        assert jac.shape == (100, 3, 3)


class TestMotionModel:
    CFG = MotionConfig(dt=1.0, a1=0.05, a2=0.05, a3=0.01, a4=0.01, a5=0.01,
                       a6=0.01)

    def test_mean_matches_oracle(self):
        pose = np.array([1.0, 0.0, np.pi / 2.0])
        v, w = np.pi / 2.0, np.pi / 2.0
        got = np.asarray(motion_mean(self.CFG, jnp.asarray(pose), v, w))
        want = oracles.motion_without_noise(pose, v, w, 1.0)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_noisy_matches_oracle_given_same_draws(self, rng):
        pose = np.array([1.0, 0.0, np.pi / 2.0])
        v, w = np.pi / 2.0, np.pi / 2.0
        key = jax.random.key(42)
        noise = jax.random.normal(key, (3,))
        # Feed identical draws to the oracle by reproducing the sampling.
        a = (self.CFG.a1, self.CFG.a2, self.CFG.a3, self.CFG.a4, self.CFG.a5,
             self.CFG.a6)
        want = oracles.motion_with_noise(pose, v, w, 1.0, a,
                                         np.asarray(noise),
                                         sigma_squared=True)
        got = np.asarray(motion_sample(self.CFG, key, jnp.asarray(pose), v, w))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_sigma_squared_quirk(self):
        # With the quirk on, effective std is sigma^2 (motion_model.py:46-48)
        # - for sigma < 1 the noisy samples hug the mean much tighter.
        pose = jnp.array([0.0, 0.0, 0.0])
        v, w = 1.0, 0.5
        keys = jax.random.split(jax.random.key(0), 4000)
        quirk = MotionConfig(dt=1.0, a1=0.2, a2=0.0, a3=0.0, a4=0.0, a5=0.0,
                             a6=0.0, sigma_squared_std=True)
        clean = MotionConfig(dt=1.0, a1=0.2, a2=0.0, a3=0.0, a4=0.0, a5=0.0,
                             a6=0.0, sigma_squared_std=False)
        s_q = jax.vmap(lambda k: motion_sample(quirk, k, pose, v, w))(keys)
        s_c = jax.vmap(lambda k: motion_sample(clean, k, pose, v, w))(keys)
        # sigma_v = 0.2; quirk std = 0.04, clean std = 0.2.
        assert float(jnp.std(s_q[:, 0])) < float(jnp.std(s_c[:, 0])) / 2.0

    def test_omega_guard_straight_line(self):
        cfg = MotionConfig(dt=2.0)
        pose = jnp.array([1.0, 2.0, 0.3])
        out = np.asarray(motion_mean(cfg, pose, 1.5, 0.0))
        want = np.array([1.0 + 3.0 * np.cos(0.3), 2.0 + 3.0 * np.sin(0.3),
                         0.3])
        np.testing.assert_allclose(out, want, atol=1e-5)

    def test_sample_statistics(self):
        # Thrun ch.5 banana: translational noise spreads along-track.
        cfg = MotionConfig(dt=1.0, a1=0.05, a2=0.05, a3=0.01, a4=0.01,
                           a5=0.01, a6=0.01)
        pose = jnp.array([1.0, 0.0, np.pi / 2.0])
        v = w = np.pi / 2.0
        keys = jax.random.split(jax.random.key(1), 8000)
        samples = jax.vmap(lambda k: motion_sample(cfg, k, pose, v, w))(keys)
        mean = np.asarray(jnp.mean(samples[:, :2], axis=0))
        want = oracles.motion_without_noise(np.asarray(pose), v, w, 1.0)[:2]
        # Mean of noisy propagation tracks the noiseless arc (loose band;
        # the arc is nonlinear in the noise).
        np.testing.assert_allclose(mean, want, atol=0.2)


class TestObservations:
    def test_position_observation_rotation(self):
        # With zero noise the observation equals the true position.
        pose = jnp.array([3.0, -2.0, 0.7])
        z = position_observation(jax.random.key(0), pose,
                                 jnp.zeros((2, 2)))
        np.testing.assert_allclose(np.asarray(z), [3.0, -2.0], atol=1e-6)

    def test_landmark_observation_zero_noise(self):
        pose = np.array([1.0, 1.0, 0.5])
        lms = np.array([[2.0, 3.0], [-1.0, 0.5]])
        z = landmark_observation(jax.random.key(0), jnp.asarray(pose),
                                 jnp.asarray(lms), jnp.zeros((2, 2)))
        np.testing.assert_allclose(np.asarray(z),
                                   oracles.world2robot(pose, lms), atol=1e-5)


class TestScanSensor:
    CFG = ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                     dist_gain=0.05, dir_sigma=math.radians(2.0),
                     orient_sigma=math.radians(2.0))
    LMS = np.array([[0.0, 0.0], [14.0, 1.0], [9.0, 9.0], [0.0, 15.0],
                    [-11.0, 10.0], [-14.0, 1.0], [-10.0, -9.0],
                    [0.0, -16.0], [10.0, -11.0]])

    def test_geometry_matches_oracle(self):
        pose = np.array([10.0, 0.0, np.pi / 2.0])
        s = scan_true(self.CFG, jnp.asarray(pose), jnp.asarray(self.LMS))
        dist, bearing, orient, valid = oracles.scan_true(
            pose, self.LMS, self.CFG.range_m, self.CFG.angle_rad)
        np.testing.assert_allclose(np.asarray(s.dist), dist, atol=1e-4)
        np.testing.assert_allclose(np.asarray(s.bearing), bearing, atol=1e-5)
        np.testing.assert_allclose(np.asarray(s.orient), orient, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(s.valid), valid)

    def test_fov_sector(self):
        # Landmark directly behind the robot must be invalid for a 80deg FOV.
        pose = jnp.array([0.0, 0.0, np.pi / 2.0])  # facing world +y
        lms = jnp.array([[0.0, 5.0], [0.0, -5.0], [5.0, 0.0]])
        s = scan_true(self.CFG, pose, lms)
        assert bool(s.valid[0])  # dead ahead
        assert not bool(s.valid[1])  # behind
        # 90deg off-axis is outside an 80deg half-angle sector.
        assert not bool(s.valid[2])

    def test_noise_statistics(self):
        pose = jnp.array([10.0, 0.0, np.pi / 2.0])
        keys = jax.random.split(jax.random.key(3), 2000)
        noisy, true = jax.vmap(
            lambda k: scan(self.CFG, k, pose, jnp.asarray(self.LMS)))(keys)
        i = int(np.argmax(np.asarray(true.valid[0])))
        d_true = float(true.dist[0, i])
        d_std = float(jnp.std(noisy.dist[:, i]))
        assert np.isclose(d_std, d_true * self.CFG.dist_gain, rtol=0.15)
        b_std = float(jnp.std(noisy.bearing[:, i]))
        assert np.isclose(b_std, self.CFG.dir_sigma, rtol=0.15)

    def test_measurement_cov_matches_oracle(self):
        got = np.asarray(measurement_cov(self.CFG, 7.0))
        want = oracles.measurement_cov(7.0, self.CFG.dist_gain,
                                       self.CFG.dir_sigma,
                                       self.CFG.orient_sigma)
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_cov_rotations_match_oracle(self):
        cov = oracles.measurement_cov(7.0, 0.05, 0.03, 0.03)
        lm_dir, yaw = 0.4, 1.1
        got_w = np.asarray(cov_measurement_to_world(jnp.asarray(cov), lm_dir,
                                                    yaw))
        want_w = oracles.rot_z_cov(cov, lm_dir + yaw - oracles.BASE_ANG)
        np.testing.assert_allclose(got_w, want_w, atol=1e-6)
        got_r = np.asarray(cov_measurement_to_robot(jnp.asarray(cov), lm_dir))
        np.testing.assert_allclose(got_r, oracles.rot_z_cov(cov, lm_dir),
                                   atol=1e-6)

    def test_batched_poses(self, rng):
        poses = jnp.asarray(rng.normal(size=(6, 3)))
        s = scan_true(self.CFG, poses, jnp.asarray(self.LMS))
        assert s.dist.shape == (6, 9)
        assert s.valid.shape == (6, 9)


class TestOmegaGuardFlag:
    def test_guard_off_reproduces_reference_division(self):
        """With omega_guard=False and w=0 the reference raises
        ZeroDivisionError (motion_model.py:50,73); Python-scalar inputs
        reproduce that exactly, array inputs produce non-finite values."""
        cfg = MotionConfig(dt=1.0, omega_guard=False)
        pose = jnp.array([0.0, 0.0, 0.0])
        with pytest.raises(ZeroDivisionError):
            motion_mean(cfg, pose, 1.0, 0.0)
        out = np.asarray(motion_mean(cfg, pose, jnp.asarray(1.0),
                                     jnp.asarray(0.0)))
        assert not np.isfinite(out[:2]).all()

    def test_guard_on_identical_for_nonzero_omega(self, rng):
        """The guard changes nothing when w != 0."""
        on = MotionConfig(dt=0.5, omega_guard=True)
        off = MotionConfig(dt=0.5, omega_guard=False)
        pose = jnp.asarray(rng.normal(size=3))
        a = np.asarray(motion_mean(on, pose, 1.3, 0.7))
        b = np.asarray(motion_mean(off, pose, 1.3, 0.7))
        np.testing.assert_allclose(a, b, atol=1e-6)
