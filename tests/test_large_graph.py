"""Large-scale graph SLAM tests: banded assembly vs dense, CG solver,
end-to-end convergence on a synthetic loop."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from slamsim.models.scan_sensor import ScanConfig
from slamsim.slam import GraphConfig
from slamsim.slam.large import (assemble_banded, banded_matvec,
                                build_edge_blocks, cg_solve,
                                graph_solve_banded, make_large_scene,
                                window_pairs)
from slamsim.slam.graph import (assemble, build_edges, kept_times,
                                upper_pairs)


pytestmark = pytest.mark.slow  # interpret-mode Pallas / multi-device suites: run in the full tier only


def _cfg(t1, num_lm, **kw):
    return GraphConfig(
        max_times=t1, num_landmarks=num_lm,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)), **kw)


class TestWindowPairs:
    def test_full_window_is_all_pairs(self):
        valid = np.zeros((5, 2), bool)
        valid[[0, 2, 4], 0] = True
        valid[[1, 3], 1] = True
        el = window_pairs(valid, window=10)
        # landmark 0: (0,2),(0,4),(2,4); landmark 1: (1,3) -> 4 edges
        assert el.t_b.shape == (4,)

    def test_window_limits_span(self):
        valid = np.zeros((10, 1), bool)
        valid[[0, 3, 9], 0] = True
        el = window_pairs(valid, window=4)
        pairs = set(zip(np.asarray(el.t_b).tolist(),
                        np.asarray(el.t_a).tolist()))
        assert pairs == {(0, 3)}  # (0,9) and (3,9) exceed window 4


class TestWindowPairsDevice:
    """Jittable edge construction == host construction (as an edge SET)."""

    @staticmethod
    def _edge_set(el, n=None):
        tb = np.asarray(el.t_b)
        ta = np.asarray(el.t_a)
        lm = np.asarray(el.lm)
        v = np.asarray(el.valid)
        return {(int(b), int(a), int(m))
                for b, a, m, ok in zip(tb, ta, lm, v) if ok}

    def test_matches_host_random(self, rng):
        from slamsim.slam import (count_window_pairs, window_pairs_device)

        valid = rng.random((40, 6)) < 0.4
        for window in (1, 3, 40):
            host = window_pairs(valid, window=window)
            n_exact = count_window_pairs(valid, window)
            assert host.t_b.shape[0] == n_exact
            dev, n = jax.jit(
                lambda v: window_pairs_device(v, window, n_exact + 5),
                static_argnums=())(jnp.asarray(valid))
            assert int(n) == n_exact
            assert self._edge_set(dev) == self._edge_set(host)

    def test_truncation_reports_count(self, rng):
        from slamsim.slam import window_pairs_device

        valid = jnp.asarray(rng.random((20, 3)) < 0.8)
        el, n = window_pairs_device(valid, window=10, max_edges=4)
        assert int(n) > 4  # true count reported
        assert int(jnp.sum(el.valid)) == 4  # list truncated to capacity

    def test_solve_with_device_edges(self, rng):
        """Banded GN solve driven end-to-end from device-built edges
        matches the host-built edge list's solution."""
        from slamsim.core.angles import wrap_angle
        from slamsim.slam import (count_window_pairs, make_large_scene,
                                  window_pairs_device)

        cfg = _cfg(60, 12, exact_jacobians=True, max_gn_iters=5)
        pt, po, obs = make_large_scene(cfg, jax.random.key(1), 60, 12,
                                       radius=15.0, odom_noise=0.05)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        w = 10
        n = count_window_pairs(np.asarray(obs.valid), w)
        el_host = window_pairs(np.asarray(obs.valid), window=w)
        el_dev, _ = window_pairs_device(obs.valid, w, n)
        res_h = graph_solve_banded(cfg, po, obs, el_host, band=w,
                                   rel_odom=rel_odom, solver="tridiag")
        res_d = graph_solve_banded(cfg, po, obs, el_dev, band=w,
                                   rel_odom=rel_odom, solver="tridiag")
        np.testing.assert_allclose(np.asarray(res_d.poses),
                                   np.asarray(res_h.poses), atol=1e-4)


class TestBandedVsDense:
    def _setup(self, t_steps=8, seed=0):
        from slamsim.slam import SlamSceneConfig, simulate

        cfg = _cfg(t_steps + 1, 9)
        scene = SlamSceneConfig()
        traj = simulate(scene, cfg, jax.random.key(seed), t_steps)
        return cfg, traj

    def test_banded_assembly_matches_dense(self):
        """Full-window banded H must equal the dense path's H."""
        cfg, traj = self._setup()
        t1 = 9
        el = window_pairs(np.asarray(traj.obs.valid), window=t1)
        blocks = build_edge_blocks(cfg, traj.poses_odom, traj.obs, el)
        h_band, bvec, kept = assemble_banded(cfg, blocks, el, t1,
                                             band=t1 - 1)

        pi, pj = upper_pairs(t1)
        edges = build_edges(cfg, traj.poses_odom, traj.obs,
                            jnp.asarray(t1 - 1), pi, pj)
        kept_d = kept_times(traj.obs, t1 - 1)
        h_dense, b_dense = assemble(cfg, edges, kept_d, pi, pj, t1)

        # Reconstruct dense H from the band and compare.
        h_from_band = np.zeros((3 * t1, 3 * t1), np.float64)
        hb = np.asarray(h_band, np.float64)
        for d in range(t1):
            for i in range(t1 - d):
                blk = hb[d, i]
                h_from_band[3 * i:3 * i + 3,
                            3 * (i + d):3 * (i + d) + 3] += blk
                if d > 0:
                    h_from_band[3 * (i + d):3 * (i + d) + 3,
                                3 * i:3 * i + 3] += blk.T
        np.testing.assert_allclose(h_from_band, np.asarray(h_dense),
                                   rtol=2e-3, atol=2e-2)
        np.testing.assert_allclose(np.asarray(bvec).ravel(),
                                   np.asarray(b_dense), rtol=2e-3,
                                   atol=2e-2)

    def test_matvec_matches_dense(self, rng):
        cfg, traj = self._setup()
        t1 = 9
        el = window_pairs(np.asarray(traj.obs.valid), window=t1)
        blocks = build_edge_blocks(cfg, traj.poses_odom, traj.obs, el)
        h_band, _, _ = assemble_banded(cfg, blocks, el, t1, band=t1 - 1)
        x = rng.normal(size=(t1, 3)).astype(np.float32)
        y = np.asarray(banded_matvec(h_band, jnp.asarray(x)))

        # Dense reference from the band itself.
        hb = np.asarray(h_band, np.float64)
        h_dense = np.zeros((3 * t1, 3 * t1))
        for d in range(t1):
            for i in range(t1 - d):
                h_dense[3 * i:3 * i + 3,
                        3 * (i + d):3 * (i + d) + 3] += hb[d, i]
                if d > 0:
                    h_dense[3 * (i + d):3 * (i + d) + 3,
                            3 * i:3 * i + 3] += hb[d, i].T
        want = (h_dense @ x.reshape(-1)).reshape(t1, 3)
        np.testing.assert_allclose(y, want, rtol=1e-3, atol=1e-3)

    def test_cg_matches_direct_solve(self, rng):
        cfg, traj = self._setup()
        t1 = 9
        el = window_pairs(np.asarray(traj.obs.valid), window=t1)
        blocks = build_edge_blocks(cfg, traj.poses_odom, traj.obs, el)
        h_band, bvec, _ = assemble_banded(cfg, blocks, el, t1, band=t1 - 1)
        x, iters = cg_solve(h_band, bvec, max_iters=500, tol=1e-12)
        hx = np.asarray(banded_matvec(h_band, x))
        res = np.linalg.norm(hx - np.asarray(bvec)) / (
            np.linalg.norm(np.asarray(bvec)) + 1e-30)
        assert res < 1e-3
        assert int(iters) < 500


class TestLargeSceneEndToEnd:
    def test_solve_converges_and_improves(self):
        """200-pose / 40-landmark loop with heavy odometry drift: banded
        GN with the odometry chain + exact Jacobians must substantially
        reduce the drift against ground truth."""
        from slamsim.core.angles import wrap_angle

        noise = 0.3
        cfg = _cfg(200, 40, max_gn_iters=20, exact_jacobians=True)
        poses_true, poses_odom, obs = make_large_scene(
            cfg, jax.random.key(0), 200, 40, radius=60.0,
            odom_noise=noise)
        rel_odom = poses_odom[1:] - poses_odom[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=30)
        assert el.t_b.shape[0] > 100  # scene produces real constraints
        res = graph_solve_banded(
            cfg, poses_odom, obs, el, band=30, rel_odom=rel_odom,
            odom_info=(1 / noise ** 2,) * 3)
        err_odo = np.asarray(poses_odom[:, :2] - poses_true[:, :2])
        err_est = np.asarray(res.poses[:, :2] - poses_true[:, :2])
        rmse_odo = np.sqrt((err_odo ** 2).sum(-1).mean())
        rmse_est = np.sqrt((err_est ** 2).sum(-1).mean())
        assert np.isfinite(rmse_est)
        assert rmse_est < 0.7 * rmse_odo
        assert int(res.gn_iters) >= 1

    def test_no_nan_without_odometry_chain(self):
        """Landmark-only graphs (the reference's formulation) must stay
        finite even when weakly anchored."""
        cfg = _cfg(100, 20, max_gn_iters=10, exact_jacobians=True)
        poses_true, poses_odom, obs = make_large_scene(
            cfg, jax.random.key(1), 100, 20, radius=40.0, odom_noise=0.1)
        el = window_pairs(np.asarray(obs.valid), window=20)
        res = graph_solve_banded(cfg, poses_odom, obs, el, band=20)
        assert np.isfinite(np.asarray(res.poses)).all()


class TestBandedCholesky:
    def test_factor_matches_dense(self, rng):
        from slamsim.slam.cholesky import banded_cholesky, \
            banded_chol_solve

        t1, band = 12, 3
        d1 = band + 1
        n = 3 * t1
        b_mat = rng.normal(size=(n, n)) * (
            np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 2)
        a = b_mat @ b_mat.T + np.eye(n) * 5.0
        for i in range(t1):
            for j in range(t1):
                if abs(i - j) > band:
                    a[3 * i:3 * i + 3, 3 * j:3 * j + 3] = 0
        a = (a + a.T) / 2 + np.eye(n) * 5.0
        hb = np.zeros((d1, t1, 3, 3))
        for d in range(d1):
            for i in range(t1 - d):
                hb[d, i] = a[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3]
        x_true = rng.normal(size=n)
        rhs = a @ x_true
        lb = banded_cholesky(jnp.asarray(hb, jnp.float32))
        x = banded_chol_solve(lb, jnp.asarray(rhs.reshape(t1, 3),
                                              jnp.float32))
        rel = np.linalg.norm(np.asarray(x).ravel() - x_true) / \
            np.linalg.norm(x_true)
        assert rel < 1e-5
        l_dense = np.linalg.cholesky(a)
        lb_np = np.asarray(lb)
        for d in range(d1):
            for i in range(t1 - d):
                np.testing.assert_allclose(
                    lb_np[d, i],
                    l_dense[3 * (i + d):3 * (i + d) + 3, 3 * i:3 * i + 3],
                    atol=1e-5)

    def test_solver_option_in_gn(self):
        """cholesky solver gives the same GN result as CG."""
        from slamsim.core.angles import wrap_angle

        noise = 0.3
        cfg = _cfg(100, 20, max_gn_iters=10, exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(3), 100, 20,
                                      radius=40.0, odom_noise=noise)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=20)
        kw = dict(band=20, rel_odom=rel_odom,
                  odom_info=(1 / noise ** 2,) * 3)
        r_cg = graph_solve_banded(cfg, po, obs, el, solver="cg", **kw)
        r_ch = graph_solve_banded(cfg, po, obs, el, solver="cholesky",
                                  **kw)
        np.testing.assert_allclose(np.asarray(r_ch.poses),
                                   np.asarray(r_cg.poses), atol=2e-2)


class TestTridiagSolver:
    def test_solve_matches_dense(self, rng):
        from slamsim.slam.tridiag import banded_solve_tridiag

        t1, band = 23, 4
        d1 = band + 1
        n = 3 * t1
        b_mat = rng.normal(size=(n, n)) * (
            np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3)
        a = b_mat @ b_mat.T + np.eye(n) * 4.0
        for i in range(t1):
            for j in range(t1):
                if abs(i - j) > band:
                    a[3 * i:3 * i + 3, 3 * j:3 * j + 3] = 0
        a = (a + a.T) / 2 + np.eye(n) * 4.0
        hb = np.zeros((d1, t1, 3, 3))
        for d in range(d1):
            for i in range(t1 - d):
                hb[d, i] = a[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3]
        x_true = rng.normal(size=n)
        rhs = a @ x_true
        for super_size in (None, 8):
            x = banded_solve_tridiag(
                jnp.asarray(hb, jnp.float32),
                jnp.asarray(rhs.reshape(t1, 3), jnp.float32),
                super_size=super_size)
            rel = np.linalg.norm(np.asarray(x).ravel() - x_true) / \
                np.linalg.norm(x_true)
            assert rel < 1e-4

    def test_partitioned_thomas_matches_sequential(self, rng):
        """Single-chip SPIKE (block_thomas_factor_partitioned): the
        chunked factor + reduced interface solve reproduces the
        sequential block-Thomas solution to machine precision (f64) on
        random SPD block-tridiagonal systems, across chunk counts."""
        from slamsim.slam.tridiag import (
            block_thomas_factor_partitioned, block_thomas_solve,
            block_thomas_substitute_partitioned)

        jax.config.update("jax_enable_x64", True)
        try:
            n, m = 24, 5
            a = np.stack([np.eye(m) * (6 + i % 3)
                          + 0.3 * rng.normal(size=(m, m))
                          for i in range(n)])
            a = 0.5 * (a + a.transpose(0, 2, 1))
            u = 0.3 * rng.normal(size=(n - 1, m, m))
            b = rng.normal(size=(n, m))
            x_ref = np.asarray(block_thomas_solve(
                jnp.asarray(a), jnp.asarray(u), jnp.asarray(b)))
            for c in (2, 4, 12):  # m_chunk = 12, 6, 2
                fac = block_thomas_factor_partitioned(
                    jnp.asarray(a), jnp.asarray(u), c)
                x = np.asarray(block_thomas_substitute_partitioned(
                    fac, jnp.asarray(b)))
                np.testing.assert_allclose(x, x_ref, atol=1e-12,
                                           err_msg=f"n_parts={c}")
            # m_blk = 5 above exercises the lax fallback; m_blk = 6
            # (a multiple of 3) takes the blocked closed-form inverse
            # (inv_impl="blocked", the production super-block case).
            m6 = 6
            a6 = np.stack([np.eye(m6) * (6 + i % 3)
                           + 0.3 * rng.normal(size=(m6, m6))
                           for i in range(n)])
            a6 = 0.5 * (a6 + a6.transpose(0, 2, 1))
            u6 = 0.3 * rng.normal(size=(n - 1, m6, m6))
            b6 = rng.normal(size=(n, m6))
            x_ref6 = np.asarray(block_thomas_solve(
                jnp.asarray(a6), jnp.asarray(u6), jnp.asarray(b6)))
            for c in (2, 4, 12):
                for impl in ("blocked", "lax"):
                    fac = block_thomas_factor_partitioned(
                        jnp.asarray(a6), jnp.asarray(u6), c,
                        inv_impl=impl)
                    x = np.asarray(block_thomas_substitute_partitioned(
                        fac, jnp.asarray(b6)))
                    np.testing.assert_allclose(
                        x, x_ref6, atol=1e-11,
                        err_msg=f"n_parts={c} inv_impl={impl}")
            with pytest.raises(ValueError):
                block_thomas_factor_partitioned(
                    jnp.asarray(a), jnp.asarray(u), 7)  # 24 % 7 != 0
            with pytest.raises(ValueError):
                block_thomas_factor_partitioned(
                    jnp.asarray(a), jnp.asarray(u), 24)  # m = 1 < 2
        finally:
            jax.config.update("jax_enable_x64", False)

    def test_partitioned_gn_matches_sequential(self):
        """graph_solve_banded(n_parts=...) on the factor-reuse path
        lands on the sequential solution (f32 solver roundoff)."""
        from slamsim.core.angles import wrap_angle

        noise = 0.3
        cfg = _cfg(128, 20, max_gn_iters=10, exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(3), 128, 20,
                                      radius=40.0, odom_noise=noise)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=20)
        kw = dict(band=20, rel_odom=rel_odom,
                  odom_info=(1 / noise ** 2,) * 3, solver="tridiag")
        r_seq = graph_solve_banded(cfg, po, obs, el, **kw)
        r_par = graph_solve_banded(cfg, po, obs, el, n_parts=4, **kw)
        assert int(r_par.gn_iters) >= 1
        np.testing.assert_allclose(np.asarray(r_par.poses),
                                   np.asarray(r_seq.poses), atol=5e-3)
        with pytest.raises(ValueError):
            graph_solve_banded(cfg, po, obs, el, n_parts=4,
                               reuse_factorization=False, **kw)

    def test_solver_option_in_gn(self):
        from slamsim.core.angles import wrap_angle

        noise = 0.3
        cfg = _cfg(100, 20, max_gn_iters=10, exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(3), 100, 20,
                                      radius=40.0, odom_noise=noise)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=20)
        kw = dict(band=20, rel_odom=rel_odom,
                  odom_info=(1 / noise ** 2,) * 3)
        r_cg = graph_solve_banded(cfg, po, obs, el, solver="cg", **kw)
        r_td = graph_solve_banded(cfg, po, obs, el, solver="tridiag", **kw)
        np.testing.assert_allclose(np.asarray(r_td.poses),
                                   np.asarray(r_cg.poses), atol=2e-2)


class TestPcgDriver:
    """Edge cases of the shared PCG driver (core/pcg.py)."""

    def test_zero_rhs_short_circuits(self):
        from slamsim.core.pcg import pcg

        b = jnp.zeros((8, 3))
        x, it = pcg(lambda x: x, lambda r: r, lambda a, c: jnp.sum(a * c),
                    b, 50, 1e-8)
        assert int(it) == 0
        np.testing.assert_array_equal(np.asarray(x), 0.0)

    def test_identity_system_converges_immediately(self, rng):
        from slamsim.core.pcg import pcg

        b = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
        x, it = pcg(lambda x: x, lambda r: r, lambda a, c: jnp.sum(a * c),
                    b, 50, 1e-10)
        np.testing.assert_allclose(np.asarray(x), np.asarray(b),
                                   atol=1e-6)
        assert int(it) <= 2

    def test_semidefinite_direction_does_not_blow_up(self):
        """A matvec that kills one component (singular H) must stop with
        finite output instead of dividing by ~0 curvature."""
        from slamsim.core.pcg import pcg

        mask = jnp.asarray([1.0, 1.0, 0.0])

        def matvec(x):
            return x * mask

        b = jnp.asarray([[1.0, 2.0, 3.0]])
        x, it = pcg(matvec, lambda r: r,
                    lambda a, c: jnp.sum(a * c), b, 50, 1e-12)
        assert np.isfinite(np.asarray(x)).all()


class TestChunkedScene:
    def test_chunked_scan_matches_visibility(self):
        """Chunked scene generation: identical FOV mask (deterministic
        geometry) and same-shape noisy fields as the unchunked path."""
        cfg = _cfg(40, 8, exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(1), 40, 8,
                                       radius=15.0, odom_noise=0.05)
        pt2, po2, obs2 = make_large_scene(cfg, jax.random.key(1), 40, 8,
                                          radius=15.0, odom_noise=0.05,
                                          scan_chunk=10)
        np.testing.assert_array_equal(np.asarray(obs.valid),
                                      np.asarray(obs2.valid))
        np.testing.assert_allclose(np.asarray(pt), np.asarray(pt2))
        np.testing.assert_allclose(np.asarray(po), np.asarray(po2))
        assert obs2.dist.shape == obs.dist.shape
        assert np.isfinite(np.asarray(obs2.dist)).all()

    def test_chunk_must_divide(self):
        cfg = _cfg(40, 8)
        with pytest.raises(ValueError):
            make_large_scene(cfg, jax.random.key(0), 40, 8,
                             scan_chunk=7)


class TestCyclicReductionSolver:
    def _banded_system(self, rng, t1, band):
        d1 = band + 1
        n = 3 * t1
        b_mat = rng.normal(size=(n, n)) * (
            np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3)
        a = b_mat @ b_mat.T + np.eye(n) * 4.0
        for i in range(t1):
            for j in range(t1):
                if abs(i - j) > band:
                    a[3 * i:3 * i + 3, 3 * j:3 * j + 3] = 0
        a = (a + a.T) / 2 + np.eye(n) * 4.0
        hb = np.zeros((d1, t1, 3, 3))
        for d in range(d1):
            for i in range(t1 - d):
                hb[d, i] = a[3 * i:3 * i + 3, 3 * (i + d):3 * (i + d) + 3]
        x_true = rng.normal(size=n)
        return a, hb, x_true, a @ x_true

    def test_cr_matches_dense(self, rng):
        from slamsim.slam.cyclic import banded_solve_cr

        for t1, band, ss in ((23, 4, None), (23, 4, 8), (64, 3, 4),
                             (5, 1, None)):
            a, hb, x_true, rhs = self._banded_system(rng, t1, band)
            x = banded_solve_cr(
                jnp.asarray(hb, jnp.float32),
                jnp.asarray(rhs.reshape(t1, 3), jnp.float32),
                super_size=ss)
            rel = np.linalg.norm(np.asarray(x).ravel() - x_true) / \
                np.linalg.norm(x_true)
            assert rel < 1e-4, (t1, band, ss, rel)

    def test_cr_matches_thomas_on_tridiag_blocks(self, rng):
        """block_cr_solve == block_thomas_solve on a random SPD
        block-tridiagonal system (power-of-two N)."""
        from slamsim.slam.cyclic import block_cr_solve
        from slamsim.slam.tridiag import block_thomas_solve

        n, m = 8, 6
        u = jnp.asarray(rng.normal(size=(n - 1, m, m)) * 0.2, jnp.float32)
        d = jnp.asarray(
            np.stack([np.eye(m) * 4.0 + 0.1 * (lambda q: q + q.T)(
                rng.normal(size=(m, m))) for _ in range(n)]), jnp.float32)
        b = jnp.asarray(rng.normal(size=(n, m)), jnp.float32)
        x_cr = block_cr_solve(d, u, b)
        x_th = block_thomas_solve(d, u, b)
        np.testing.assert_allclose(np.asarray(x_cr), np.asarray(x_th),
                                   atol=1e-4)

    def test_cr_solver_option_in_gn(self):
        from slamsim.core.angles import wrap_angle

        noise = 0.3
        cfg = _cfg(100, 20, max_gn_iters=10, exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(3), 100, 20,
                                      radius=40.0, odom_noise=noise)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=20)
        kw = dict(band=20, rel_odom=rel_odom,
                  odom_info=(1 / noise ** 2,) * 3)
        r_cr = graph_solve_banded(cfg, po, obs, el, solver="cr", **kw)
        r_td = graph_solve_banded(cfg, po, obs, el, solver="tridiag", **kw)
        np.testing.assert_allclose(np.asarray(r_cr.poses),
                                   np.asarray(r_td.poses), atol=2e-2)


class TestFlatCr:
    """Flat-layout cyclic reduction vs the (D, T1, 3, 3) original (the
    flat path is now the production CR route; same scaling rationale as
    TestFlatTridiag)."""

    @pytest.mark.parametrize("t1,band,s", [(48, 4, 8), (60, 3, 4),
                                           (40, 5, None), (23, 4, None)])
    def test_matches_band_cr(self, rng, t1, band, s):
        from slamsim.slam.cyclic import banded_solve_cr, banded_solve_cr_flat

        d1 = band + 1
        h_flat = np.zeros((d1 * 9, t1), np.float32)
        for d in range(d1):
            blkv = rng.normal(size=(t1, 3, 3)).astype(np.float32) * 0.3
            if d == 0:
                blkv = 0.5 * (blkv + blkv.transpose(0, 2, 1))
                blkv += np.eye(3, dtype=np.float32)[None] * (band + 4.0)
            for a in range(3):
                for b_ in range(3):
                    h_flat[d * 9 + 3 * a + b_, :] = blkv[:, a, b_]
            if d:
                h_flat[d * 9:(d + 1) * 9, t1 - d:] = 0.0
        b3 = rng.normal(size=(3, t1)).astype(np.float32)
        h_flat = jnp.asarray(h_flat)
        b3 = jnp.asarray(b3)
        h_band = jnp.transpose(h_flat.reshape(d1, 9, t1),
                               (0, 2, 1)).reshape(d1, t1, 3, 3)
        x_band = banded_solve_cr(h_band, b3.T, super_size=s)
        x_flat = banded_solve_cr_flat(h_flat, b3, band, super_size=s)
        np.testing.assert_allclose(np.asarray(x_flat), np.asarray(x_band),
                                   rtol=2e-4, atol=2e-5)


class TestDamping:
    def test_damped_reference_formulation_stays_bounded(self):
        """The reference-compatible formulation (inconsistent Jacobians +
        relinearized Omega) diverges at hundreds of poses; with Levenberg
        damping it must stay bounded and finite."""
        from slamsim.core.angles import wrap_angle

        cfg = _cfg(200, 40, max_gn_iters=15)  # exact_jacobians=False
        pt, po, obs = make_large_scene(cfg, jax.random.key(0), 200, 40,
                                      radius=60.0, odom_noise=0.1)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=30)
        res = graph_solve_banded(
            cfg, po, obs, el, band=30, rel_odom=rel_odom,
            odom_info=(100.0,) * 3, relinearize_omega=True, damping=1.0)
        est = np.asarray(res.poses)
        assert np.isfinite(est).all()
        err = np.sqrt(((est[:, :2] - np.asarray(pt)[:, :2]) ** 2)
                      .sum(-1).mean())
        assert err < 10.0  # bounded (odometry drift is ~1.5 m)


class TestFlatTridiag:
    """Flat-layout tridiagonal pipeline vs the (D, T1, 3, 3) original
    (the flat path is the production tridiag route - its intermediates
    keep the trajectory axis minor, avoiding the tile-padded layouts
    that OOM beyond ~150k poses)."""

    def _random_banded(self, rng, t1, band):
        d1 = band + 1
        h_flat = np.zeros((d1 * 9, t1), np.float32)
        # SPD-ish: random band + diagonal dominance
        for d in range(d1):
            blkv = rng.normal(size=(t1, 3, 3)).astype(np.float32) * 0.3
            if d == 0:
                blkv = 0.5 * (blkv + blkv.transpose(0, 2, 1))
                blkv += np.eye(3, dtype=np.float32)[None] * (band + 4.0)
            for a in range(3):
                for b_ in range(3):
                    h_flat[d * 9 + 3 * a + b_, :] = blkv[:, a, b_]
            # zero entries that would reference poses beyond the end
            if d:
                h_flat[d * 9:(d + 1) * 9, t1 - d:] = 0.0
        b = rng.normal(size=(3, t1)).astype(np.float32)
        return jnp.asarray(h_flat), jnp.asarray(b)

    @pytest.mark.parametrize("t1,band,s", [(48, 4, 8), (60, 3, 12),
                                           (40, 5, 5)])
    def test_matches_band_solver(self, rng, t1, band, s):
        from slamsim.slam.tridiag import (banded_solve_tridiag,
                                          banded_solve_tridiag_flat)

        h_flat, b3 = self._random_banded(rng, t1, band)
        d1 = band + 1
        h_band = jnp.transpose(h_flat.reshape(d1, 9, t1),
                               (0, 2, 1)).reshape(d1, t1, 3, 3)
        x_band = banded_solve_tridiag(h_band, b3.T, super_size=s)
        x_flat = banded_solve_tridiag_flat(h_flat, b3, band, super_size=s)
        np.testing.assert_allclose(np.asarray(x_flat), np.asarray(x_band),
                                   rtol=2e-4, atol=2e-5)

    def test_graph_solve_tridiag_uses_flat(self, rng):
        """End-to-end graph solve on the tridiag path still converges
        and matches the CR solver (which runs the band layout)."""
        import math
        from slamsim.core.angles import wrap_angle
        from slamsim.models.scan_sensor import ScanConfig
        from slamsim.slam import (GraphConfig, graph_solve_banded,
                                  make_large_scene, window_pairs)

        t1 = 200
        cfg = GraphConfig(
            max_times=t1, num_landmarks=30, max_gn_iters=6,
            scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                            dist_gain=0.05, dir_sigma=math.radians(2.0),
                            orient_sigma=math.radians(2.0)),
            exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(0), t1, 30,
                                       radius=60.0, odom_noise=0.05)
        el = window_pairs(np.asarray(obs.valid), window=12)
        rel = po[1:] - po[:-1]
        rel = rel.at[:, 2].set(wrap_angle(rel[:, 2]))
        kw = dict(band=12, rel_odom=rel, odom_info=(100.0, 100.0, 100.0),
                  delta_tol=1e-4 * t1)
        r_td = graph_solve_banded(cfg, po, obs, el, solver="tridiag", **kw)
        r_cr = graph_solve_banded(cfg, po, obs, el, solver="cr", **kw)
        np.testing.assert_allclose(np.asarray(r_td.poses),
                                   np.asarray(r_cr.poses), atol=5e-3)
        assert np.isfinite(np.asarray(r_td.poses)).all()
        assert int(r_td.gn_iters) >= 1


class TestFlatCholesky:
    """Flat-layout banded Cholesky vs the (D, T1, 3, 3) original (the
    flat path is now the production direct-solver route; same scaling
    rationale as TestFlatTridiag - the streaming (T1, D*9) scans never
    materialize a trailing-(3, 3) tensor at trajectory length)."""

    @pytest.mark.parametrize("t1,band", [(48, 4), (60, 3), (40, 5),
                                         (23, 4)])
    def test_matches_band_solver(self, rng, t1, band):
        from slamsim.slam.cholesky import (banded_solve_direct,
                                           banded_solve_direct_flat)

        h_flat, b3 = TestFlatTridiag._random_banded(None, rng, t1, band)
        d1 = band + 1
        h_band = jnp.transpose(h_flat.reshape(d1, 9, t1),
                               (0, 2, 1)).reshape(d1, t1, 3, 3)
        x_band = banded_solve_direct(h_band, b3.T)
        x_flat = banded_solve_direct_flat(h_flat, b3, band)
        np.testing.assert_allclose(np.asarray(x_flat), np.asarray(x_band),
                                   rtol=2e-4, atol=2e-5)


class TestFlatCg:
    """Flat-layout matvec + PCG vs the band-layout original."""

    @pytest.mark.parametrize("t1,band", [(48, 4), (60, 3), (23, 4)])
    def test_matvec_matches_band(self, rng, t1, band):
        from slamsim.slam.large import (make_banded_matvec,
                                        make_banded_matvec_flat)

        h_flat, b3 = TestFlatTridiag._random_banded(None, rng, t1, band)
        d1 = band + 1
        h_band = jnp.transpose(h_flat.reshape(d1, 9, t1),
                               (0, 2, 1)).reshape(d1, t1, 3, 3)
        y_band = make_banded_matvec(h_band)(b3.T)  # (T1, 3)
        y_flat = make_banded_matvec_flat(h_flat, band)(b3)  # (3, T1)
        np.testing.assert_allclose(np.asarray(y_flat.T),
                                   np.asarray(y_band),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("t1,band", [(48, 4), (60, 3)])
    def test_cg_matches_band_cg(self, rng, t1, band):
        from slamsim.slam.large import cg_solve, cg_solve_flat

        h_flat, b3 = TestFlatTridiag._random_banded(None, rng, t1, band)
        d1 = band + 1
        h_band = jnp.transpose(h_flat.reshape(d1, 9, t1),
                               (0, 2, 1)).reshape(d1, t1, 3, 3)
        x_band, it_b = cg_solve(h_band, b3.T, max_iters=500, tol=1e-12)
        x_flat, it_f = cg_solve_flat(h_flat, b3, band, max_iters=500,
                                     tol=1e-12)
        np.testing.assert_allclose(np.asarray(x_flat), np.asarray(x_band),
                                   rtol=2e-4, atol=2e-5)

    def test_graph_solve_cg_and_cholesky_flat_paths(self, rng):
        """End-to-end GN on the (now flat) cg/cholesky paths matches the
        tridiag production solver."""
        import math
        from slamsim.core.angles import wrap_angle
        from slamsim.models.scan_sensor import ScanConfig
        from slamsim.slam import (GraphConfig, graph_solve_banded,
                                  make_large_scene, window_pairs)

        t1 = 200
        cfg = GraphConfig(
            max_times=t1, num_landmarks=30, max_gn_iters=6,
            scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                            dist_gain=0.05, dir_sigma=math.radians(2.0),
                            orient_sigma=math.radians(2.0)),
            exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(0), t1, 30,
                                       radius=60.0, odom_noise=0.05)
        el = window_pairs(np.asarray(obs.valid), window=12)
        rel = po[1:] - po[:-1]
        rel = rel.at[:, 2].set(wrap_angle(rel[:, 2]))
        kw = dict(band=12, rel_odom=rel, odom_info=(100.0, 100.0, 100.0),
                  delta_tol=1e-4 * t1)
        r_td = graph_solve_banded(cfg, po, obs, el, solver="tridiag", **kw)
        r_ch = graph_solve_banded(cfg, po, obs, el, solver="cholesky",
                                  **kw)
        r_cg = graph_solve_banded(cfg, po, obs, el, solver="cg", **kw)
        np.testing.assert_allclose(np.asarray(r_ch.poses),
                                   np.asarray(r_td.poses), atol=2e-2)
        # CG is iterative (residual-tol stop): allow the same cross-
        # solver spread the cr-vs-tridiag test uses.
        np.testing.assert_allclose(np.asarray(r_cg.poses),
                                   np.asarray(r_td.poses), atol=2e-2)


class TestFactorReuse:
    """Factor-once/substitute-many Thomas split + the constant-H GN
    fast path (graph_solve_banded reuse_factorization)."""

    @staticmethod
    def _random_block_tridiag(rng, n=6, m=9):
        mats = rng.normal(size=(n, m, m))
        diag = jnp.asarray(
            mats @ mats.transpose(0, 2, 1) + 8.0 * np.eye(m), jnp.float32)
        upper = jnp.asarray(rng.normal(size=(n - 1, m, m)) * 0.1,
                            jnp.float32)
        return diag, upper

    def test_factor_substitute_bit_matches_solve(self, rng):
        from slamsim.slam.tridiag import (block_thomas_factor,
                                          block_thomas_solve,
                                          block_thomas_substitute)

        diag, upper = self._random_block_tridiag(rng)
        b = jnp.asarray(rng.normal(size=(6, 9)), jnp.float32)
        want = block_thomas_solve(diag, upper, b)
        got = block_thomas_substitute(block_thomas_factor(diag, upper), b)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        # Multi-rhs rank is preserved too.
        b2 = jnp.asarray(rng.normal(size=(6, 4, 9)), jnp.float32)
        want2 = block_thomas_solve(diag, upper, b2)
        got2 = block_thomas_substitute(
            block_thomas_factor(diag, upper), b2)
        np.testing.assert_array_equal(np.asarray(got2), np.asarray(want2))

    def test_flat_factor_resolve_matches_one_shot(self, rng):
        from slamsim.slam.tridiag import (banded_factor_tridiag_flat,
                                          banded_resolve_tridiag_flat,
                                          banded_solve_tridiag_flat)

        t1, band = 23, 4
        d1 = band + 1
        n = 3 * t1
        b_mat = rng.normal(size=(n, n)) * (
            np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 3)
        a = b_mat @ b_mat.T + np.eye(n) * 8.0
        for i in range(t1):
            for j in range(t1):
                if abs(i - j) > band:
                    a[3 * i:3 * i + 3, 3 * j:3 * j + 3] = 0
        a = (a + a.T) / 2 + np.eye(n) * 8.0
        h_flat = np.zeros((d1 * 9, t1), np.float32)
        for d in range(d1):
            for r in range(3):
                for c in range(3):
                    for i in range(t1 - d):
                        h_flat[d * 9 + 3 * r + c, i] = \
                            a[3 * i + r, 3 * (i + d) + c]
        rhs = jnp.asarray(rng.normal(size=(3, t1)), jnp.float32)
        hf = jnp.asarray(h_flat)
        for ss in (8, 16):
            want = banded_solve_tridiag_flat(hf, rhs, band, super_size=ss)
            fac = banded_factor_tridiag_flat(hf, band, super_size=ss)
            got = banded_resolve_tridiag_flat(fac, rhs, ss)
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))

    @staticmethod
    def _gn_scene(seed=3, t1=100):
        from slamsim.core.angles import wrap_angle

        noise = 0.3
        cfg = _cfg(t1, 20, max_gn_iters=10, exact_jacobians=True)
        pt, po, obs = make_large_scene(cfg, jax.random.key(seed), t1, 20,
                                       radius=40.0, odom_noise=noise)
        rel_odom = po[1:] - po[:-1]
        rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
        el = window_pairs(np.asarray(obs.valid), window=20)
        kw = dict(band=20, rel_odom=rel_odom,
                  odom_info=(1 / noise ** 2,) * 3)
        return cfg, pt, po, obs, el, kw

    def test_reuse_gn_matches_one_shot(self):
        cfg, pt, po, obs, el, kw = self._gn_scene()
        r_reuse = graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                     **kw)  # auto-enabled
        r_once = graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                    reuse_factorization=False, **kw)
        assert int(r_reuse.gn_iters) == int(r_once.gn_iters)
        np.testing.assert_allclose(np.asarray(r_reuse.poses),
                                   np.asarray(r_once.poses), atol=1e-5)

    def test_stall_ratio_stops_at_noise_floor(self):
        from slamsim.models.scan_sensor import ScanConfig as _SC

        _, pt, po, obs, el, kw = self._gn_scene()
        # The f32 solve contracts delta_sum geometrically at ~kappa*eps
        # (~0.22 on this scene) until it reaches the solver noise floor,
        # where the ratio jumps toward 1.  With delta_tol below the
        # floor, the absolute criterion alone runs to max_gn_iters; the
        # stall check (default-separated at 0.5 > the working rate)
        # stops at the floor.
        cfg40 = _cfg(100, 20, max_gn_iters=40, exact_jacobians=True)
        r_max = graph_solve_banded(cfg40, po, obs, el, solver="tridiag",
                                   delta_tol=0.0, **kw)
        r_stall = graph_solve_banded(cfg40, po, obs, el, solver="tridiag",
                                     delta_tol=0.0, stall_ratio=0.5,
                                     **kw)
        assert int(r_max.gn_iters) == cfg40.max_gn_iters
        assert int(r_stall.gn_iters) < cfg40.max_gn_iters
        # Stopping at the stall point costs no accuracy.
        err_stall = np.linalg.norm(
            np.asarray(r_stall.poses[:, :2] - pt[:, :2]), axis=-1)
        err_max = np.linalg.norm(
            np.asarray(r_max.poses[:, :2] - pt[:, :2]), axis=-1)
        assert np.sqrt((err_stall ** 2).mean()) <= \
            np.sqrt((err_max ** 2).mean()) + 1e-3

    def test_reuse_requires_constant_h(self):
        cfg, pt, po, obs, el, kw = self._gn_scene()
        with pytest.raises(ValueError, match="reuse_factorization"):
            graph_solve_banded(cfg, po, obs, el, solver="cg",
                               reuse_factorization=True, **kw)
        with pytest.raises(ValueError, match="reuse_factorization"):
            graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                               relinearize_omega=True,
                               reuse_factorization=True, **kw)

    def test_refactor_every_one_is_full_relinearization(self):
        """refactor_every=1 refreshes Omega+factor at the current poses
        every iteration - the same linearization schedule as the
        relinearize_omega one-shot path, so poses/iters must agree to
        f32 solve tolerance (the rhs rebuild and staged factor/resolve
        are op-order twins of the full assembly + solve)."""
        cfg, pt, po, obs, el, kw = self._gn_scene()
        r_full = graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                    relinearize_omega=True,
                                    reuse_factorization=False, **kw)
        r_k1 = graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                                  relinearize_omega=True,
                                  refactor_every=1, **kw)
        assert int(r_k1.gn_iters) == int(r_full.gn_iters)
        # f32 rounding only (measured maxdiff 1.7e-5 on this scene).
        np.testing.assert_allclose(np.asarray(r_k1.poses),
                                   np.asarray(r_full.poses), atol=1e-4)

    def test_refactor_every_k_converges_to_same_poses(self):
        """Stale-factor iterations target the same fixed point: the
        k=3 solution matches full relinearization."""
        cfg, pt, po, obs, el, kw = self._gn_scene()
        # Tight delta_tol: both sides iterate to the common fixed point
        # (at the default 0.01 threshold GN stops while per-pose steps
        # are still ~1e-2, so the comparison would only see stopping
        # noise).  Measured: full 14 iters, k=2/3/5 reach the same poses
        # within 5e-5 in +1..3 iters.
        cfg30 = _cfg(100, 20, max_gn_iters=30, exact_jacobians=True)
        r_full = graph_solve_banded(cfg30, po, obs, el, solver="tridiag",
                                    relinearize_omega=True,
                                    reuse_factorization=False,
                                    delta_tol=1e-6, **kw)
        for k in (2, 3, 5):
            r_k = graph_solve_banded(cfg30, po, obs, el, solver="tridiag",
                                     relinearize_omega=True,
                                     refactor_every=k, delta_tol=1e-6,
                                     **kw)
            np.testing.assert_allclose(
                np.asarray(r_k.poses), np.asarray(r_full.poses),
                atol=2e-4, err_msg=f"refactor_every={k}")
            # and it actually converged, not just capped out
            assert float(r_k.delta_sum) < 1e-6
            assert int(r_k.gn_iters) <= int(r_full.gn_iters) + 4

    def test_refactor_every_validation(self):
        cfg, pt, po, obs, el, kw = self._gn_scene()
        with pytest.raises(ValueError, match="refactor_every"):
            graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                               refactor_every=0,
                               relinearize_omega=True, **kw)
        with pytest.raises(ValueError, match="refactor_every"):
            # frozen Omega: H constant, use reuse_factorization instead
            graph_solve_banded(cfg, po, obs, el, solver="tridiag",
                               refactor_every=2, **kw)
        with pytest.raises(ValueError, match="refactor_every"):
            graph_solve_banded(cfg, po, obs, el, solver="cg",
                               refactor_every=2,
                               relinearize_omega=True, **kw)
