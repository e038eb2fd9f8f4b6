"""Tests for utils (checkpoint/profiling), sim drivers, and viz demos."""

import pytest
import os

import numpy as np
import jax
import jax.numpy as jnp

import matplotlib

matplotlib.use("Agg")

from slamsim.filters import EkfConfig, PfConfig, ekf_init, ekf_step, \
    pf_init
from slamsim.sim import rollout, rollout_batch
from slamsim.utils import restore_state, save_state, steps_per_second, \
    timed


class TestCheckpoint:
    @pytest.mark.slow
    def test_roundtrip_ekf_state(self, tmp_path):
        cfg = EkfConfig()
        state = ekf_init(cfg, (4,))
        state, _ = jax.vmap(
            lambda s, k: ekf_step(cfg, s, k),
            in_axes=(0, None))(state, jax.random.key(0))
        path = os.path.join(tmp_path, "ckpt")
        save_state(path, state)
        restored = restore_state(path, state)
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_roundtrip_pf_state(self, tmp_path):
        state = pf_init(PfConfig(num_particles=64))
        path = os.path.join(tmp_path, "ckpt_pf")
        save_state(path, state)
        restored = restore_state(path, state)
        np.testing.assert_array_equal(np.asarray(state.particles),
                                      np.asarray(restored.particles))


class TestProfiling:
    def test_timed_and_throughput(self):
        f = jax.jit(lambda x: (x * 2).sum())
        x = jnp.ones((128,))
        dt = timed(f, x, reps=3)
        assert dt > 0
        assert steps_per_second(f, x, work_items=128, reps=3) > 0


class TestRoofline:
    def test_unknown_device_raises(self):
        from slamsim.utils import roofline

        with pytest.raises(KeyError, match="no published peaks"):
            roofline.peaks("cpu")

    def test_h100_entry(self):
        from slamsim.utils import roofline

        p = roofline.peaks("NVIDIA H100 80GB HBM3")
        assert p.hbm_bytes == 3.35e12 and p.flops_bf16 == 989e12
        assert "data sheet" in p.source


class TestSimDriver:
    def test_rollout_matches_manual_loop(self):
        """Generic rollout == manually iterating the step with the same
        per-step keys.  (ekf_rollout itself uses a bulk-noise stream and
        is pinned by its own golden test.)"""
        cfg = EkfConfig()
        final1, outs1 = rollout(lambda s, k: ekf_step(cfg, s, k),
                                ekf_init(cfg), jax.random.key(3), 20)
        keys = jax.random.split(jax.random.key(3), 20)
        state = ekf_init(cfg)
        for i in range(20):
            state, out = ekf_step(cfg, state, keys[i])
        np.testing.assert_allclose(np.asarray(final1.x_hat),
                                   np.asarray(state.x_hat), atol=1e-5)

    def test_rollout_batch(self):
        cfg = EkfConfig()
        keys = jax.random.split(jax.random.key(0), 4)
        final, outs = rollout_batch(lambda s, k: ekf_step(cfg, s, k),
                                    lambda: ekf_init(cfg), keys, 7)
        assert outs.x_true.shape == (4, 7, 3)


class TestVizDemos:
    """Headless smoke tests: each demo renders and saves a PNG."""

    def test_demo_ekf(self, tmp_path):
        from slamsim.viz import demo_ekf

        out = os.path.join(tmp_path, "ekf.png")
        demo_ekf.main(["--frames", "10", "--save", out])
        assert os.path.getsize(out) > 1000

    def test_demo_pf(self, tmp_path):
        from slamsim.viz import demo_pf

        out = os.path.join(tmp_path, "pf.png")
        demo_pf.main(["--frames", "5", "--particles", "100", "--save", out])
        assert os.path.getsize(out) > 1000

    @pytest.mark.slow
    def test_demo_graph_slam(self, tmp_path):
        from slamsim.viz import demo_graph_slam

        out = os.path.join(tmp_path, "slam.png")
        demo_graph_slam.main(["--frames", "5", "--save", out])
        assert os.path.getsize(out) > 1000

    def test_demo_motion(self, tmp_path):
        from slamsim.viz import demo_motion

        out = os.path.join(tmp_path, "motion.png")
        demo_motion.main(["--samples", "50", "--save", out])
        assert os.path.getsize(out) > 1000

    def test_demo_transform(self, tmp_path):
        from slamsim.viz import demo_transform

        out = os.path.join(tmp_path, "tf.png")
        demo_transform.main(["--save", out])
        assert os.path.getsize(out) > 1000

    def test_demo_ellipse(self, tmp_path):
        from slamsim.viz import demo_ellipse

        out = os.path.join(tmp_path, "ell.png")
        demo_ellipse.main(["--save", out])
        assert os.path.getsize(out) > 1000


class TestProfilerTrace:
    def test_trace_context(self, tmp_path):
        from slamsim.utils import trace

        f = jax.jit(lambda x: x * 2 + 1)
        with trace(str(tmp_path / "prof")):
            float(f(jnp.ones(())))
        # A trace directory with at least one event file must exist.
        files = list((tmp_path / "prof").rglob("*"))
        assert len(files) > 0

    @pytest.mark.slow
    def test_demo_large_slam(self, tmp_path):
        from slamsim.viz import demo_large_slam

        out = os.path.join(tmp_path, "large.png")
        demo_large_slam.main(["--poses", "60", "--landmarks", "12",
                              "--window", "15", "--save", out])
        assert os.path.getsize(out) > 1000
