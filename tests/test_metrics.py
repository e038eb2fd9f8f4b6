"""Tests for the device-side metrics module."""

import numpy as np
import jax.numpy as jnp

from slamsim.metrics import (divergence_mask, nees, nees_consistency,
                             position_rmse, summarize_rollouts, yaw_rmse)


class TestRmse:
    def test_position_rmse(self, rng):
        est = rng.normal(size=(4, 10, 3))
        truth = est.copy()
        truth[..., :2] += 0.5  # constant 0.5 m offset in x and y
        r = float(position_rmse(jnp.asarray(est), jnp.asarray(truth)))
        assert np.isclose(r, np.sqrt(0.5), atol=1e-5)  # sqrt(0.5^2+0.5^2)

    def test_yaw_rmse_wraps(self):
        est = jnp.array([[0.0, 0.0, np.pi - 0.1]])
        truth = jnp.array([[0.0, 0.0, -np.pi + 0.1]])
        # Raw difference is 2*pi - 0.2; wrapped it is 0.2.
        assert np.isclose(float(yaw_rmse(est, truth)), 0.2, atol=1e-5)


class TestNees:
    def test_nees_chi2_statistics(self, rng):
        """For errors drawn from N(0, P), mean NEES ~ dof."""
        n = 5000
        p = np.array([[2.0, 0.3], [0.3, 1.0]])
        chol = np.linalg.cholesky(p)
        err = rng.normal(size=(n, 2)) @ chol.T
        est = np.zeros((n, 3))
        est[:, :2] = err
        truth = np.zeros((n, 3))
        cov = np.tile(np.eye(3), (n, 1, 1))
        cov[:, :2, :2] = p
        vals = np.asarray(nees(jnp.asarray(est), jnp.asarray(truth),
                               jnp.asarray(cov), dims=2))
        assert np.isclose(vals.mean(), 2.0, rtol=0.1)

    def test_nees_consistency_reduces(self, rng):
        est = jnp.asarray(rng.normal(size=(3, 7, 3)))
        truth = jnp.zeros((3, 7, 3))
        cov = jnp.tile(jnp.eye(3), (3, 7, 1, 1))
        v = nees_consistency(est, truth, cov)
        assert v.shape == ()


class TestDivergence:
    def test_mask(self):
        est = np.zeros((2, 5, 3))
        est[1, 3, 0] = 1e3  # rollout 1 diverges
        truth = np.zeros((2, 5, 3))
        m = np.asarray(divergence_mask(jnp.asarray(est),
                                       jnp.asarray(truth), threshold=100.0))
        np.testing.assert_array_equal(m, [True, False])

    def test_nan_marks_divergence(self):
        est = np.zeros((1, 5, 3))
        est[0, 2, 1] = np.nan
        m = np.asarray(divergence_mask(jnp.asarray(est),
                                       jnp.zeros((1, 5, 3)), 100.0))
        assert not m[0]

    def test_summary_pytree(self, rng):
        est = jnp.asarray(rng.normal(size=(2, 6, 3)))
        truth = jnp.asarray(rng.normal(size=(2, 6, 3)))
        cov = jnp.tile(jnp.eye(3), (2, 6, 1, 1))
        s = summarize_rollouts(est, truth, cov)
        assert set(s) == {"rmse_pos", "rmse_yaw", "rmse_pos_per_rollout",
                          "diverged", "mean_nees"}
        assert s["rmse_pos_per_rollout"].shape == (2,)
