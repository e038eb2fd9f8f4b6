"""Unit tests for slamsim.core (SURVEY.md section 4, item 1)."""

import numpy as np
import jax
import jax.numpy as jnp
from scipy import stats

import oracles
from slamsim.core import (BASE_ANG, chi2_ppf_2dof, chi2_ppf_2dof_table,
                          error_ellipse, robot_to_world, world_to_robot,
                          wrap_angle, wrap_angle_fast)


class TestWrapAngle:
    def test_matches_reference_loop(self, rng):
        angles = rng.uniform(-12.0 * np.pi, 12.0 * np.pi, size=4001)
        # Exclude points within f32 rounding of the wrap boundaries (odd
        # multiples of pi), where float32 vs float64 can land on opposite
        # sides and differ by 2*pi.
        frac = np.abs(np.abs(angles) / np.pi % 2.0 - 1.0)
        angles = angles[frac > 1e-4]
        got = np.asarray(wrap_angle(angles))
        want = np.array([oracles.limit_angle(a) for a in angles])
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_large_magnitude(self):
        # |a| > 3*pi exercises multiple loop iterations in the reference.
        for a in [7.5 * np.pi, -9.3 * np.pi, 100.0, -1000.0]:
            assert np.isclose(float(wrap_angle(a)), oracles.limit_angle(a),
                              atol=1e-4)

    def test_batched_shapes(self):
        x = jnp.ones((4, 5, 6)) * 5.0
        assert wrap_angle(x).shape == (4, 5, 6)

    def test_fast_variant_agrees_off_boundary(self):
        angles = np.linspace(-10.0, 10.0, 1001)
        # Exclude exact multiples of pi where conventions differ.
        mask = np.abs(np.abs(angles) % np.pi) > 1e-3
        got = np.asarray(wrap_angle_fast(angles))[mask]
        want = np.asarray(wrap_angle(angles))[mask]
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_jit_and_grad(self):
        f = jax.jit(wrap_angle)
        assert np.isclose(float(f(3.5 * np.pi)), oracles.limit_angle(3.5 * np.pi),
                          atol=1e-5)


class TestSe2:
    def test_round_trip_identity(self, rng):
        # The reference's transform demo checks this visually
        # (mylib/transform.py:61-131).
        pose = jnp.asarray(rng.normal(size=3))
        pts = jnp.asarray(rng.normal(size=(7, 2)) * 10.0)
        back = robot_to_world(pose, world_to_robot(pose, pts))
        np.testing.assert_allclose(np.asarray(back), np.asarray(pts),
                                   atol=1e-5)

    def test_matches_oracle(self, rng):
        pose = np.array([1.0, 3.0, np.deg2rad(-10.0)])
        pts = np.array([[4.0, 4.0], [0.0, 0.0], [3.0, -1.0], [-3.0, -5.0]])
        got = np.asarray(world_to_robot(pose, pts))
        np.testing.assert_allclose(got, oracles.world2robot(pose, pts),
                                   atol=1e-5)
        got_w = np.asarray(robot_to_world(pose, pts))
        np.testing.assert_allclose(got_w, oracles.robot2world(pose, pts),
                                   atol=1e-5)

    def test_heading_convention(self):
        # At yaw = BASE_ANG the robot frame coincides with the world frame
        # up to translation (robot forward = world +y).
        pose = jnp.array([2.0, 1.0, float(BASE_ANG)])
        pts = jnp.array([[3.0, 5.0]])
        np.testing.assert_allclose(
            np.asarray(world_to_robot(pose, pts)), [[1.0, 4.0]], atol=1e-6)

    def test_batched_broadcast(self, rng):
        poses = jnp.asarray(rng.normal(size=(8, 3)))
        pts = jnp.asarray(rng.normal(size=(5, 2)))
        out = world_to_robot(poses, pts)  # batch dims broadcast
        assert out.shape == (8, 5, 2)
        # vmap equivalence
        out2 = jax.vmap(lambda p: world_to_robot(p, pts))(poses)
        np.testing.assert_allclose(np.asarray(out), np.asarray(out2),
                                   atol=1e-6)
        for i in range(8):
            np.testing.assert_allclose(
                np.asarray(out2[i]),
                oracles.world2robot(np.asarray(poses[i]), np.asarray(pts)),
                atol=1e-5)


class TestChi2:
    def test_exact_matches_scipy(self):
        for p in [99.9, 99.0, 95.0, 50.0, 10.0, 1.0]:
            want = stats.chi2.ppf(p / 100.0, df=2)
            assert np.isclose(float(chi2_ppf_2dof(p)), want, rtol=1e-5)

    def test_table_matches_exact_at_grid(self):
        for p in [99.0, 95.0, 50.0, 10.0]:
            assert np.isclose(float(chi2_ppf_2dof_table(p)),
                              float(chi2_ppf_2dof(p)), rtol=1e-5)

    def test_table_interpolates_between_grid(self):
        # Between 99.0 and 98.5 the table is linear; exact is convex.
        v = float(chi2_ppf_2dof_table(98.75))
        lo = stats.chi2.ppf(0.985, 2)
        hi = stats.chi2.ppf(0.99, 2)
        assert lo < v < hi


class TestErrorEllipse:
    def test_axis_lengths(self):
        sigma = np.diag([16.0, 9.0])
        major, minor, _ = error_ellipse(sigma, 99.0)
        chi2 = stats.chi2.ppf(0.99, 2)
        assert np.isclose(float(major), 2.0 * np.sqrt(16.0 * chi2), rtol=1e-4)
        assert np.isclose(float(minor), 2.0 * np.sqrt(9.0 * chi2), rtol=1e-4)

    def test_angle_correlated(self):
        # Strongly correlated covariance: major axis near 45 degrees.
        sigma = np.array([[4.0, 3.9], [3.9, 4.0]])
        _, _, ang = error_ellipse(sigma, 99.0, row_eigvec_compat=False)
        assert np.isclose(abs(float(ang)), np.pi / 4.0, atol=0.05)

    def test_row_quirk_matches_numpy_oracle(self, rng):
        # Each flag setting must reproduce its oracle's axis *direction*
        # (angles compare modulo pi: eigenvector sign conventions differ
        # between LAPACK builds, and an ellipse is symmetric under pi).
        for _ in range(10):
            a = rng.normal(size=(2, 2))
            sigma = a @ a.T + np.eye(2) * 0.1
            val, vec = np.linalg.eigh(sigma)
            idxmax = int(np.argmax(val))
            want_row = np.arctan2(vec[idxmax][1], vec[idxmax][0])
            want_col = np.arctan2(vec[1][idxmax], vec[0][idxmax])
            _, _, a_row = error_ellipse(sigma, 99.0, row_eigvec_compat=True)
            _, _, a_col = error_ellipse(sigma, 99.0, row_eigvec_compat=False)
            for got, want in [(float(a_row), want_row),
                              (float(a_col), want_col)]:
                d = (got - want) % np.pi
                assert min(d, np.pi - d) < 1e-4

    def test_batched(self, rng):
        a = rng.normal(size=(10, 2, 2))
        sig = a @ np.transpose(a, (0, 2, 1)) + np.eye(2) * 0.1
        major, minor, ang = error_ellipse(jnp.asarray(sig), 99.0)
        assert major.shape == (10,)
        assert bool(jnp.all(major >= minor))
