"""Property-based invariants across the stack."""

import math

import pytest

import numpy as np
import jax
import jax.numpy as jnp

from slamsim.core import robot_to_world, world_to_robot, wrap_angle
from slamsim.filters import EkfConfig, ekf_rollout
from slamsim.models.scan_sensor import ScanConfig
from slamsim.slam import (GraphConfig, SlamSceneConfig, simulate,
                          upper_pairs)
from slamsim.slam.graph import assemble, build_edges, kept_times


class TestSe2Properties:
    def test_transform_preserves_distances(self, rng):
        """SE(2) transforms are isometries."""
        for _ in range(5):
            pose = jnp.asarray(rng.normal(size=3))
            pts = jnp.asarray(rng.normal(size=(6, 2)) * 5)
            loc = np.asarray(world_to_robot(pose, pts))
            d_w = np.linalg.norm(np.asarray(pts)[None] -
                                 np.asarray(pts)[:, None], axis=-1)
            d_l = np.linalg.norm(loc[None] - loc[:, None], axis=-1)
            np.testing.assert_allclose(d_w, d_l, atol=1e-4)

    def test_wrap_idempotent(self, rng):
        a = jnp.asarray(rng.uniform(-50, 50, size=200))
        w1 = wrap_angle(a)
        w2 = wrap_angle(w1)
        np.testing.assert_allclose(np.asarray(w1), np.asarray(w2),
                                   atol=1e-5)
        assert float(jnp.max(jnp.abs(w1))) <= np.pi + 1e-5

    def test_round_trip_many_poses(self, rng):
        poses = jnp.asarray(rng.normal(size=(20, 3)) * 3)
        pts = jnp.asarray(rng.normal(size=(7, 2)) * 10)
        back = robot_to_world(poses, world_to_robot(poses, pts))
        want = jnp.broadcast_to(pts, (20, 7, 2))
        np.testing.assert_allclose(np.asarray(back), np.asarray(want),
                                   atol=1e-4)


class TestEkfInvariants:
    def test_covariance_symmetric_psd(self):
        """P stays symmetric and PSD over a long rollout."""
        _, outs = ekf_rollout(EkfConfig(), jax.random.key(0), 200)
        cov = np.asarray(outs.cov, np.float64)
        asym = np.abs(cov - np.transpose(cov, (0, 2, 1))).max()
        assert asym < 1e-5
        eigs = np.linalg.eigvalsh((cov + np.transpose(cov, (0, 2, 1))) / 2)
        assert eigs.min() > -1e-6


class TestGraphInvariants:
    @pytest.mark.slow
    def test_information_matrix_symmetric(self):
        cfg = GraphConfig(
            max_times=8, num_landmarks=9,
            scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                            dist_gain=0.05, dir_sigma=math.radians(2.0),
                            orient_sigma=math.radians(2.0)))
        traj = simulate(SlamSceneConfig(), cfg, jax.random.key(0), 7)
        pi, pj = upper_pairs(8)
        edges = build_edges(cfg, traj.poses_odom, traj.obs,
                            jnp.asarray(7), pi, pj)
        kept = kept_times(traj.obs, 7)
        h, b = assemble(cfg, edges, kept, pi, pj, 8)
        h = np.asarray(h, np.float64)
        # The premultiplied blocks make H symmetric by construction
        # (H_ab = H_ba^T for each edge).
        np.testing.assert_allclose(h, h.T, rtol=1e-4, atol=1e-3)


class TestResampleInvariants:
    """Systematic-resample structural properties of the interval decode
    (``resample_indices(method="hist")``), for any weights."""

    @staticmethod
    def _hist(w, offs):
        from slamsim.filters.pf import resample_indices_from_offs

        return np.asarray(resample_indices_from_offs(
            jnp.float32(offs), jnp.asarray(w, jnp.float32), "hist"))

    @pytest.mark.parametrize("seed,scale", [(0, 0.1), (1, 3.0), (2, 8.0)])
    def test_output_counts_equal_slot_intervals(self, seed, scale):
        """Each particle appears in the output exactly t_j - t_{j-1}
        times (its slot-interval length); the counts total n."""
        from slamsim.filters.pf import resample_indices, slot_boundaries

        rng = np.random.default_rng(seed)
        n = 512
        lw = rng.normal(size=n) * scale
        w = np.exp(lw - lw.max())
        w /= w.sum()
        key = jax.random.key(seed)
        idx = np.asarray(resample_indices(key, jnp.asarray(w, jnp.float32),
                                          method="hist"))
        offs = float(jax.random.uniform(key, dtype=jnp.float32))
        t = np.asarray(slot_boundaries(jnp.asarray(w, jnp.float32), n,
                                       jnp.float32(offs)))
        tprev = np.r_[0, t[:-1]]
        counts = np.bincount(idx, minlength=n)
        np.testing.assert_array_equal(counts, t - tprev)
        assert counts.sum() == n

    @pytest.mark.parametrize("seed,scale", [(5, 4.0), (6, 9.0)])
    def test_degenerate_weights_no_double_cover(self, seed, scale):
        """Continuous degenerate log-weights (the regime that fires the
        gate): every output slot is covered by exactly one particle, in
        the exact quantized-integer intervals.  Guards the quantized
        cumsum - an unquantized f32 cumsum can invert an interval."""
        n = 256
        rng = np.random.default_rng(seed)
        lw = rng.normal(size=n) * scale
        w = np.exp(lw - lw.max())
        w /= w.sum()
        idx = self._hist(w, 0.5)
        # One particle per slot, in order: a double-covered slot would
        # show as a decrease.
        assert idx.shape == (n,) and (np.diff(idx) >= 0).all()
        # Exact quantized-integer oracle: integer cumsum, f32 scale and
        # ceil, offs = 0.5.
        wq = np.round(np.float32(w) * np.float32(1 << 20)
                      / np.float32(np.float32(w).sum())).astype(np.int64)
        cum = np.cumsum(wq)
        inv = np.float32(1.0) / np.float32(cum[-1])
        t = np.clip(np.ceil(np.float32(n) * (cum.astype(np.float32) * inv)
                            - np.float32(0.5)), 0, n).astype(np.int64)
        t[-1] = n
        expect = t - np.r_[0, t[:-1]]
        np.testing.assert_array_equal(np.bincount(idx, minlength=n), expect)

    def test_exact_binary_weights_counts(self):
        """Exact binary-fraction weights give deterministic slot counts."""
        n = 128
        heavy = {3: 1 / 4, 60: 1 / 4, 100: 1 / 2}
        w = np.zeros(n)
        for h, wv in heavy.items():
            w[h] = wv
        idx = self._hist(w, 0.5)
        t = np.clip(np.ceil(n * np.cumsum(w) - 0.5), 0, n)
        t[-1] = n
        expect = (t - np.r_[0, t[:-1]]).astype(int)
        np.testing.assert_array_equal(np.bincount(idx, minlength=n), expect)
        assert set(np.unique(idx)) == set(heavy)
