"""The fused EKF kernel in the Pallas interpreter, and its generator.

The kernel lowers through Triton on the GPU; here it runs with
``interpret=True``, which checks its arithmetic, layout, padding and
noise streams.  What the GPU compiler makes of it is checked by
``chip_smoke.py`` (tests/test_chip_smoke.py runs the same checks on a
GPU when one is present).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend.random import threefry_2x32

from slamsim.filters import EkfConfig
from slamsim.ops import ekf_fused_rollout, rng
from slamsim.ops.ekf_pallas import launch_shape

import chip_smoke

CFG = EkfConfig()


def _u32(x):
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.int32),
                                        jnp.uint32)


def _i32(x):
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.uint32),
                                        jnp.int32)


class TestEkfFusedKernel:
    @pytest.mark.parametrize("batch", [64, 37])
    def test_noise_free_matches_scan_path(self, batch):
        """Noise off: every rollout equals the XLA scan oracle - a whole
        number of blocks and a ragged batch padded to one."""
        diffs = chip_smoke.ekf_noise_free(batch=batch, n_steps=25,
                                          interpret=True, atol=1e-6)
        assert diffs["err"] == 0.0

    def test_noise_on_inside_reference_bands(self):
        """Noise on, 512 rollouts x the fixture's 120 steps: the kernel's
        and the scan's RMSE and NEES inside the reference's bands."""
        out = chip_smoke.ekf_bands(batch=512, interpret=True)
        assert set(out) == {"kernel_rmse", "kernel_nees", "xla_rmse",
                            "xla_nees"}

    def test_rollout_stream_independent_of_batch(self):
        """Rollout i draws the stream of (seed, first_index + i): a slice
        of a batch equals the same rollouts run on their own."""
        whole, err = ekf_fused_rollout(CFG, 9, batch=96, n_steps=6,
                                       interpret=True)
        part, perr = ekf_fused_rollout(CFG, 9, batch=40, n_steps=6,
                                       interpret=True, first_index=50)
        np.testing.assert_array_equal(np.asarray(whole.x_hat[50:90]),
                                      np.asarray(part.x_hat))
        np.testing.assert_array_equal(np.asarray(err[50:90]),
                                      np.asarray(perr))

    def test_seed_changes_stream(self):
        a, _ = ekf_fused_rollout(CFG, 1, batch=32, n_steps=4,
                                 interpret=True)
        b, _ = ekf_fused_rollout(CFG, 2, batch=32, n_steps=4,
                                 interpret=True)
        assert not np.array_equal(np.asarray(a.x_hat), np.asarray(b.x_hat))

    def test_nees_output_and_shapes(self):
        final, err, nees = ekf_fused_rollout(CFG, 3, batch=33, n_steps=8,
                                             with_nees=True, interpret=True)
        assert final.x_true.shape == final.x_dr.shape == (33, 3)
        assert final.cov.shape == (33, 3, 3)
        assert err.shape == nees.shape == (33,)
        assert np.all(np.asarray(nees) > 0.0)

    @pytest.mark.parametrize("batch,want", [
        (1, (32, 1)), (8192, (32, 1)), (4 * 132 * 64, (64, 2)),
        (8_388_608, (128, 4))])
    def test_launch_shape(self, batch, want):
        """One rollout per thread; small batches keep small blocks so the
        grid spreads over every SM, large ones use 128-rollout blocks."""
        assert launch_shape(batch) == want


class TestCounterRng:
    @pytest.mark.parametrize("key,ctr", [
        ((0, 0), (0, 0)), ((12345, 7), (399, 2)),
        ((0xDEADBEEF, 0xFFFFFFFF), (0x80000000, 1))])
    def test_threefry_matches_jax(self, key, ctr):
        """The int32 Threefry-2x32 gives jax's bits for (key, counter)."""
        want = threefry_2x32(jnp.asarray(key, jnp.uint32),
                             jnp.asarray(ctr, jnp.uint32))
        got = rng.threefry2x32(_i32(key[0]), _i32(key[1]), _i32(ctr[0]),
                               _i32(ctr[1]))
        np.testing.assert_array_equal(np.asarray(_u32(jnp.stack(got))),
                                      np.asarray(want))

    def test_normals_deterministic_by_counter(self):
        lanes = jnp.arange(8, dtype=jnp.int32)
        a = rng.normals(jnp.int32(4), lanes, jnp.int32(17), 5)
        b = rng.normals(jnp.int32(4), lanes, jnp.int32(17), 5)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_streams_distinct_per_rollout_step_and_draw(self):
        lanes = jnp.arange(256, dtype=jnp.int32)
        draws = np.stack([np.asarray(x) for step in (0, 1, 2)
                          for x in rng.normals(jnp.int32(4), lanes,
                                               jnp.int32(step), 6)])
        # 3 steps x 6 draws x 256 rollouts: no value repeats anywhere.
        assert np.unique(draws).size == draws.size

    def test_uniform_and_normal_moments(self):
        n = 1 << 16
        lanes = jnp.arange(n, dtype=jnp.int32)
        u1, u2 = rng.uniforms(*rng.threefry2x32(jnp.int32(1), lanes,
                                                jnp.int32(0), 0))
        for u in (np.asarray(u1, np.float64), np.asarray(u2, np.float64)):
            assert 0.0 <= u.min() and u.max() < 1.0
            se = np.sqrt(1 / 12 / n)
            assert abs(u.mean() - 0.5) < 5 * se
            assert abs(u.var() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
        z = np.concatenate([np.asarray(x, np.float64) for x in rng.normals(
            jnp.int32(2), lanes, jnp.int32(3), 4)])
        m = z.size
        assert abs(z.mean()) < 5 / np.sqrt(m)
        assert abs(z.var() - 1.0) < 5 * np.sqrt(2 / m)
        assert abs(np.mean(z ** 3)) < 5 * np.sqrt(15 / m)
        assert abs(np.mean(z ** 4) - 3.0) < 5 * np.sqrt(96 / m)

    def test_sincos_turns_accuracy(self):
        u = jnp.asarray(np.linspace(0.0, 1.0, 100001)[:-1], jnp.float32)
        c, s = rng.sincos_turns(u)
        ref = 2 * np.pi * np.asarray(u, np.float64)
        assert np.max(np.abs(np.asarray(c) - np.cos(ref))) < 5e-7
        assert np.max(np.abs(np.asarray(s) - np.sin(ref))) < 5e-7
