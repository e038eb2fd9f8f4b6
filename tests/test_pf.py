"""Particle-filter parity + fidelity tests (SURVEY.md section 4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy import stats

import oracles
from slamsim.filters import (PfConfig, bivariate_normal_pdf,
                             effective_sample_size, pf_init,
                             pf_likelihood, pf_rollout, pf_step,
                             systematic_resample)


CFG = PfConfig()


class TestBivariateNormal:
    def test_matches_scipy_independent(self, rng):
        d = rng.normal(size=(50, 2))
        got = np.asarray(bivariate_normal_pdf(d[:, 0], d[:, 1], 0.3, 0.3))
        want = stats.multivariate_normal(mean=[0, 0],
                                         cov=np.diag([0.09, 0.09])).pdf(d)
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_matches_scipy_correlated(self, rng):
        d = rng.normal(size=(50, 2))
        sx, sy, sxy = 0.5, 0.4, 0.1
        got = np.asarray(bivariate_normal_pdf(d[:, 0], d[:, 1], sx, sy, sxy))
        cov = np.array([[sx * sx, sxy], [sxy, sy * sy]])
        want = stats.multivariate_normal(mean=[0, 0], cov=cov).pdf(d)
        np.testing.assert_allclose(got, want, rtol=1e-4)


class TestResampling:
    def test_matches_reference_walk(self, rng):
        """Vectorized searchsorted == the reference's sequential comb walk
        (particle_filter.py:212-221) given the same offset."""
        n = 100
        w = rng.random(n)
        w = w / w.sum()
        particles = rng.normal(size=(n, 3))
        cum = np.cumsum(w)
        offs = 0.37 / n
        resample_id = np.arange(0.0, 1.0, 1.0 / n) + offs
        # Reference sequential walk.
        idx_ref = np.empty(n, dtype=int)
        idx = 0
        for i in range(n):
            while resample_id[i] > cum[idx]:
                idx += 1
            idx_ref[i] = idx
        idx_vec = np.searchsorted(cum, resample_id, side="left")
        np.testing.assert_array_equal(idx_vec, idx_ref)

    def test_preserves_distribution(self, rng):
        n = 5000
        particles = jnp.asarray(rng.normal(size=(n, 3)))
        w = np.zeros(n)
        w[:10] = 1.0 / 10.0  # all mass on first 10 particles
        newp, neww = systematic_resample(jax.random.key(0), particles,
                                         jnp.asarray(w))
        assert newp.shape == (n, 3)
        np.testing.assert_allclose(np.asarray(neww), 1.0 / n)
        # Every resampled particle must be one of the first 10.
        src = np.asarray(particles[:10])
        got = np.asarray(newp)
        for row in got[:50]:
            assert np.min(np.abs(src - row).sum(axis=1)) < 1e-6

    def test_ess(self):
        w = jnp.full(100, 0.01)
        assert np.isclose(float(effective_sample_size(w)), 100.0)
        w = jnp.zeros(100).at[0].set(1.0)
        assert np.isclose(float(effective_sample_size(w)), 1.0)


class TestLikelihood:
    def test_true_pose_has_max_likelihood(self, rng):
        """A particle at the observed pose beats perturbed ones."""
        pose = np.array([10.0, 0.0, np.pi / 2.0])
        lm = np.asarray(CFG.landmarks)
        z = oracles.world2robot(pose, lm)  # noise-free observation
        particles = np.tile(pose, (50, 1))
        particles[1:] += rng.normal(size=(49, 3)) * 0.5
        like = np.asarray(pf_likelihood(CFG, jnp.asarray(particles),
                                        jnp.asarray(z)))
        assert like.argmax() == 0

    def test_log_mode_matches_linear(self, rng):
        pose = np.array([10.0, 0.0, np.pi / 2.0])
        lm = np.asarray(CFG.landmarks)
        z = oracles.world2robot(pose, lm) + rng.normal(size=lm.shape) * 0.1
        particles = np.tile(pose, (20, 1)) + rng.normal(size=(20, 3)) * 0.2
        lin = np.asarray(pf_likelihood(CFG, jnp.asarray(particles),
                                       jnp.asarray(z)))
        log_cfg = PfConfig(weight_mode="log")
        lg = np.asarray(pf_likelihood(log_cfg, jnp.asarray(particles),
                                      jnp.asarray(z)))
        # Linear mode underflows to 0 for far particles (that is the
        # failure mode log mode exists to avoid); compare where finite.
        mask = lin > 0
        assert mask.sum() >= 5
        np.testing.assert_allclose(np.log(lin[mask]), lg[mask], atol=1e-3)


class TestPfStep:
    def test_shapes(self):
        state = pf_init(CFG)
        state2, out = jax.jit(
            lambda s, k: pf_step(CFG, s, k))(state, jax.random.key(0))
        assert state2.particles.shape == (1000, 3)
        assert out.x_est.shape == (3,)
        assert np.isclose(float(out.weights.sum()), 1.0, atol=1e-4)

    @pytest.mark.slow
    def test_estimate_is_argmax_particle(self):
        state = pf_init(CFG)
        state, out = pf_step(CFG, state, jax.random.key(1))
        idx = int(out.max_idx)
        np.testing.assert_allclose(np.asarray(out.x_est),
                                   np.asarray(out.particles[idx]), atol=1e-6)

    @pytest.mark.slow
    def test_mean_estimate_mode(self):
        cfg = PfConfig(estimate="mean")
        state = pf_init(cfg)
        state, out = pf_step(cfg, state, jax.random.key(1))
        assert out.x_est.shape == (3,)

    def test_tracking_fidelity(self):
        """Filter fidelity: PF estimate stays within a band of the truth
        over the reference's 36 s course (360 steps, 1000 particles)."""
        cfg = PfConfig(weight_mode="log")
        _, outs = jax.jit(lambda k: pf_rollout(cfg, k, 360))(
            jax.random.key(7))
        err = np.asarray(outs.x_est[:, :2] - outs.x_true[:, :2])
        rmse = np.sqrt((err ** 2).sum(-1).mean())
        # Observation std is 0.3 per axis and 5 landmarks: estimate should
        # stay well under 1 m RMSE after burn-in.
        assert rmse < 1.0

    def test_linear_mode_also_tracks(self):
        _, outs = jax.jit(lambda k: pf_rollout(CFG, k, 200))(
            jax.random.key(9))
        err = np.asarray(outs.x_est[50:, :2] - outs.x_true[50:, :2])
        rmse = np.sqrt((err ** 2).sum(-1).mean())
        assert rmse < 1.5

    def test_resampling_triggers(self):
        """Over a long run the ESS gate must fire at least once."""
        _, outs = pf_rollout(CFG, jax.random.key(3), 300)
        assert bool(np.asarray(outs.resampled).any())

    @pytest.mark.slow
    def test_scaling_particle_counts(self):
        """100 -> 10k particles (BASELINE config 2 shape check)."""
        for npart in [100, 10000]:
            cfg = PfConfig(num_particles=npart, weight_mode="log")
            state = pf_init(cfg)
            state, out = jax.jit(
                lambda s, k: pf_step(cfg, s, k))(state, jax.random.key(0))
            assert state.particles.shape == (npart, 3)


class TestHistResample:
    @pytest.mark.slow
    def test_hist_matches_search(self, rng):
        """Histogram selection == searchsorted selection away from exact
        float ties."""
        for trial in range(10):
            n = 256
            w = rng.random(n) + 1e-3
            w = w / w.sum()
            particles = jnp.asarray(
                np.arange(n, dtype=np.float64)[:, None].repeat(3, 1))
            key = jax.random.key(trial)
            p_s, _ = systematic_resample(key, particles, jnp.asarray(w),
                                         method="search")
            p_h, _ = systematic_resample(key, particles, jnp.asarray(w),
                                         method="hist")
            # Selected indices are encoded in the particle values.
            np.testing.assert_array_equal(np.asarray(p_s[:, 0]),
                                          np.asarray(p_h[:, 0]))

    @pytest.mark.slow
    def test_hist_distribution(self, rng):
        """Counts per particle are within +-1 of N*w (systematic
        resampling guarantee)."""
        n = 1000
        w = rng.random(n)
        w = w / w.sum()
        particles = jnp.asarray(
            np.arange(n, dtype=np.float64)[:, None].repeat(3, 1))
        p_h, _ = systematic_resample(jax.random.key(0), particles,
                                     jnp.asarray(w), method="hist")
        idx = np.asarray(p_h[:, 0]).astype(int)
        counts = np.bincount(idx, minlength=n)
        expect = n * w
        assert np.all(np.abs(counts - expect) <= 1.0 + 1e-6)


class TestBatchedRollouts:
    @pytest.mark.slow
    def test_pf_rollout_batch_matches_single(self):
        """Per-filter results of the vmapped sweep equal individual
        rollouts (the vmap'd cond-as-select must not change selection)."""
        from slamsim.filters import pf_rollout_batch

        cfg = PfConfig(num_particles=64, weight_mode="log")
        keys = jax.random.split(jax.random.key(7), 4)
        finals, outs = jax.jit(
            lambda k: pf_rollout_batch(cfg, k, 15))(keys)
        assert outs.x_est.shape == (4, 15, 3)
        for b in range(4):
            _, single = pf_rollout(cfg, keys[b], 15)
            np.testing.assert_allclose(np.asarray(outs.x_est[b]),
                                       np.asarray(single.x_est),
                                       atol=1e-5)
            np.testing.assert_array_equal(np.asarray(outs.resampled[b]),
                                          np.asarray(single.resampled))


class TestQuantizedCum:
    """The boundary-cumsum invariants every interval decode relies on
    (filters/pf.py::quantized_cum)."""

    @pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 10.0),
                                            (2, 40.0)])
    def test_monotone_and_exact_partition(self, seed, scale):
        from slamsim.filters.pf import quantized_cum, slot_boundaries

        rng = np.random.default_rng(seed)
        n = 4096
        lw = rng.normal(size=n) * scale  # incl. extreme dynamic range
        w = np.exp(lw - lw.max())
        w /= w.sum()
        cum, total = (np.asarray(x) for x in quantized_cum(
            jnp.asarray(w, jnp.float32)))
        # integer-exact and non-decreasing
        assert (cum == np.round(cum)).all()
        assert (np.diff(cum) >= 0).all()
        assert float(total[0]) == cum[-1]
        # slot intervals partition [0, n): t non-decreasing, last == n
        t = np.asarray(slot_boundaries(
            jnp.asarray(w, jnp.float32), n, jnp.float32(0.37)))
        assert (np.diff(t) >= 0).all()
        assert t[-1] == n
        tprev = np.r_[0, t[:-1]]
        assert (t - tprev).sum() == n
