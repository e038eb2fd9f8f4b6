"""Distributional fidelity vs the LIVE reference (SURVEY.md §4.2).

numpy's MT19937 cannot be bit-matched from JAX, so beyond the exact-replay
tests (test_reference_exec.py) the SURVEY requires a *distributional*
match: summary statistics over N seeded rollouts must fall inside bands
measured from the executing reference.  The bands live in
``tests/fixtures/ref_distributions.json``, generated once by
``scripts/gen_ref_distributions.py`` (100 seeds through the live
/root/reference EKF and PF with the mlab shim); this test recomputes the
SAME statistics from slamsim rollouts with jax.random keys and compares:

  * means via a two-sample z-style bound
    |m_ours - m_ref| <= K * sqrt((s_ref^2 + s_ours^2) / N)
  * spread via a bounded std ratio.

A likelihood bias (wrong sigma, wrong pdf normalization), a broken
resample law, or a covariance-update error moves rmse_pos / fire_count /
mean_nees far outside these bands while leaving the exact-replay tests
(which feed recorded noise through whatever law is implemented) green.

Statistic definitions mirror scripts/gen_ref_distributions.py exactly:
reference anchors extended_kalman_filter.py:86-130 (x_pre is the returned
estimate) and particle_filter.py:86-119, 200-224 (MAP estimate, ESS gate).
"""

import json
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "ref_distributions.json"

pytestmark = [
    pytest.mark.skipif(not FIXTURE.exists(),
                       reason="ref_distributions.json fixture not present"),
]

K_SIGMA = 8.0  # band width in combined standard errors
STD_RATIO = 1.75  # allowed spread mismatch factor


@pytest.fixture(scope="module")
def bands():
    return json.loads(FIXTURE.read_text())


def check(name, ours, ref_stats, n_ref):
    ours = np.asarray(ours, float)
    n = ours.size
    m, s = float(ours.mean()), float(ours.std(ddof=1))
    tol = K_SIGMA * np.sqrt(ref_stats["std"] ** 2 / n_ref + s ** 2 / n)
    assert abs(m - ref_stats["mean"]) <= tol, (
        f"{name}: mean {m:.4f} vs reference {ref_stats['mean']:.4f} "
        f"+- {tol:.4f} (std ours {s:.4f} ref {ref_stats['std']:.4f})")
    if ref_stats["std"] > 1e-12 and s > 1e-12:
        ratio = s / ref_stats["std"]
        assert 1.0 / STD_RATIO <= ratio <= STD_RATIO, (
            f"{name}: std ratio {ratio:.2f} outside "
            f"[{1 / STD_RATIO:.2f}, {STD_RATIO:.2f}]")


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


@pytest.mark.slow
class TestEkfDistributional:

    def test_rmse_and_nees_bands(self, bands):
        from slamsim.filters import EkfConfig, ekf_rollout_batch

        n_seeds = bands["n_seeds"]
        n_steps = bands["ekf_steps"]
        cfg = EkfConfig()
        keys = jax.random.split(jax.random.key(424242), n_seeds)
        _, outs = jax.jit(ekf_rollout_batch,
                          static_argnums=(0, 2))(cfg, keys, n_steps)
        # outs fields are (B, T, ...): vmap adds B outside the scan's T.
        x_pre = np.asarray(outs.x_pre)
        x_true = np.asarray(outs.x_true)
        cov = np.asarray(outs.cov)
        e = x_pre - x_true
        e[..., 2] = wrap(e[..., 2])
        rmse = np.sqrt((e[..., 0] ** 2 + e[..., 1] ** 2).mean(axis=1))
        sol = np.linalg.solve(cov, e[..., None])[..., 0]
        nees = np.einsum("bti,bti->bt", e, sol).mean(axis=1)
        check("ekf.rmse_pos", rmse, bands["ekf"]["rmse_pos"], n_seeds)
        check("ekf.mean_nees", nees, bands["ekf"]["mean_nees"], n_seeds)


@pytest.mark.slow
class TestPfDistributional:

    def test_rmse_fires_and_ess_bands(self, bands):
        from slamsim.filters import (PfConfig, effective_sample_size,
                                     pf_rollout_batch)

        n_seeds = bands["n_seeds"]
        n_steps = bands["pf_steps"]
        cfg = PfConfig()
        keys = jax.random.split(jax.random.key(31337), n_seeds)
        finals, outs = jax.jit(pf_rollout_batch,
                               static_argnums=(0, 2))(cfg, keys, n_steps)
        x_est = np.asarray(outs.x_est)
        x_true = np.asarray(outs.x_true)
        e = x_est[..., :2] - x_true[..., :2]
        rmse = np.sqrt((e ** 2).sum(-1).mean(axis=1))
        fires = np.asarray(outs.resampled).sum(axis=1)
        # Alignment with the fixture: the reference rows record
        # ESS(pw)/NP AFTER each step t = 1..60; outs.ess[t] is the ESS
        # ENTERING step t+1, so [after step 1 .. after step T-1] =
        # outs.ess[:, 1:], and the final state's weights give after-step-T.
        ess_final = np.asarray(effective_sample_size(finals.weights))
        ess = np.concatenate(
            [np.asarray(outs.ess)[:, 1:], ess_final[:, None]], axis=1)
        ess_frac = (ess / cfg.num_particles).mean(axis=1)
        check("pf.rmse_pos", rmse, bands["pf"]["rmse_pos"], n_seeds)
        check("pf.fire_count", fires, bands["pf"]["fire_count"], n_seeds)
        check("pf.mean_ess_frac", ess_frac, bands["pf"]["mean_ess_frac"],
              n_seeds)


def _graph_course_stats(section, bands, n_seeds_ours):
    """Run slam_rollout's key-driven course for ``n_seeds_ours`` seeds and
    compare rmse/iteration/guard statistics against the live-reference
    bands (the native noise wiring of
    slam/frontend.py::simulate, scales / frames / scan-vs-motion key
    splits, is exactly what the recorded-draw replay tests bypass).

    Statistic definitions mirror scripts/gen_ref_distributions.py::
    run_graph_seed: rmse over positions at OBSERVED times (the poses the
    reference plots, graph_based_slam.py:441-449), per-frame GN loop
    count (capped at max_gn_iters on BOTH sides), det/cond guard
    failures (graph_based_slam.py:496).
    """
    from slamsim.slam import (SlamSceneConfig, observed_times_mask,
                              reference_course_config, slam_rollout)

    n_frames = bands[section + "_frames"]
    n_ref = bands[section]["n_seeds"]
    cfg = reference_course_config(n_frames)
    scene = SlamSceneConfig()

    def course(k):
        traj, poses_est, frames = slam_rollout(scene, cfg, k, n_frames)
        mask = observed_times_mask(traj.obs)
        e2 = jnp.sum((poses_est[:, :2] - traj.poses_actu[:, :2]) ** 2,
                     axis=-1)
        rmse = jnp.sqrt(jnp.sum(jnp.where(mask, e2, 0.0))
                        / jnp.sum(mask))
        iters = jnp.sum(jnp.minimum(frames.gn_iters, cfg.max_gn_iters))
        fails = jnp.sum(~frames.is_calc)
        return rmse, iters, fails

    keys = jax.random.split(jax.random.key(5150), n_seeds_ours)
    rmse, iters, fails = jax.jit(jax.vmap(course))(keys)
    check(section + ".rmse_pos", rmse, bands[section]["rmse_pos"], n_ref)
    check(section + ".total_gn_iters", iters,
          bands[section]["total_gn_iters"], n_ref)
    # Guard-failure counts are heavily zero-inflated (reference 18-frame
    # mean 2.2, std 4.0): assert the mean band only - a std-ratio check
    # on a skewed count statistic is noise, not signal.
    ours = np.asarray(fails, float)
    ref = bands[section]["calc_failures"]
    tol = K_SIGMA * np.sqrt(ref["std"] ** 2 / n_ref
                            + ours.std(ddof=1) ** 2 / ours.size)
    assert abs(ours.mean() - ref["mean"]) <= max(tol, 1.0), (
        f"{section}.calc_failures: mean {ours.mean():.3f} vs reference "
        f"{ref['mean']:.3f} +- {tol:.3f}")


@pytest.mark.slow
class TestGraphDistributional:
    """The 18-frame reference demo course, native-key noise (slow tier)."""

    def test_course_bands(self, bands):
        _graph_course_stats("graph", bands, bands["graph"]["n_seeds"])


class TestGraphDistributionalFast:
    """6-frame prefix of the course - smoke tier, so CI always gates on
    the graph estimator's native-RNG statistics."""

    def test_course_bands_fast(self, bands):
        _graph_course_stats("graph_fast", bands, 64)


class TestFixtureFreshness:
    """The bands are only valid for the configs they were generated
    against: assert the committed snapshot equals the LIVE defaults so a
    default drift invalidates the fixture loudly.
    Regenerate with ``python scripts/gen_ref_distributions.py``."""

    def test_fixture_config_is_fresh(self, bands):
        import importlib.util
        import pathlib

        spec = importlib.util.spec_from_file_location(
            "gen_ref_distributions",
            pathlib.Path(__file__).parent.parent / "scripts" /
            "gen_ref_distributions.py")
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        live = gen.slamsim_config_snapshot()
        assert "gen_config" in bands, (
            "fixture predates the config snapshot - regenerate it: "
            "python scripts/gen_ref_distributions.py")
        for side, want in live.items():
            assert bands["gen_config"].get(side) == want, (
                f"fixture gen_config[{side!r}] != live defaults - the "
                "committed bands were generated against different "
                "configs; regenerate: python scripts/"
                "gen_ref_distributions.py")
        assert bands["n_seeds"] == 100
        assert bands["ekf_steps"] == 120 and bands["pf_steps"] == 60
        assert bands["graph_frames"] == 18
        assert bands["graph_fast_frames"] == 6
