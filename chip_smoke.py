#!/usr/bin/env python
"""Smoke test of the simulator's main path on a GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One card runs, at the sizes of the repo's own configurations:

  1. EKF Monte-Carlo: the fused Triton kernel (``ops.ekf_fused_rollout``)
     and the XLA scan (``filters.ekf_rollout_batch``) at 8,192 x 400 and
     8,388,608 x 100; the kernel against the scan with the noise off,
     both against the reference's distributional bands with it on, and
     the scan on the GPU against the host CPU.
  2. Particle filter, XLA path: ``pf_rollout`` at 1M particles x 100
     steps and ``pf_rollout_batch`` at 1,024 x 1,000 x 100, with the
     batched filters against the reference's bands.
  3. Graph SLAM: the 18-frame reference course (GPU against host CPU),
     the 4,096-pose cross-solver check, and the 100k-pose banded solve.

Four cards run the rollout-sharded EKF sweeps, the particle-sharded PF
step and the pose-sharded tridiagonal GN iteration, each against the
one-card call.

Every phase prints its wall time (fenced by ``block_until_ready``) beside
the card's name and power limit.  The last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failed check raises, so the script exits non-zero and prints no
such line, as it does when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from slamsim.core.angles import wrap_angle
from slamsim.filters import (EkfConfig, PfConfig, ekf_init,
                             ekf_rollout_batch, ekf_step_with_noise,
                             effective_sample_size, pf_rollout,
                             pf_rollout_batch)
from slamsim.ops import ekf_fused_rollout
from slamsim.utils import runtime

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "ref_distributions.json"
#: Band half-width in combined standard errors (ours and the fixture's).
K_SE = 4.0
#: Allowed ratio of our spread to the fixture's.
STD_RATIO = 1.75
CFG = EkfConfig()
_CARD = ["(card not read)"]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, reps: int = 3):
    """``(result, first_call_s, median_s)``; every call is fenced by
    ``block_until_ready`` and the first includes compilation."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def report(phase: str, what: str, first: float, median: float,
           extra: str = "") -> None:
    log(f"[{phase}] {what}: {median * 1e3:.3f} ms median "
        f"(first call incl. compile {first:.2f} s){extra} | {_CARD[0]}")


def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def check_band(name: str, values, ref: dict, n_ref: int,
               k: float = K_SE) -> tuple[float, float]:
    """Our mean within ``k`` combined standard errors of the fixture's,
    our spread within ``STD_RATIO`` of its spread; returns
    ``(mean, bound)``."""
    v = np.asarray(values, np.float64)
    m, s = float(v.mean()), float(v.std(ddof=1))
    bound = k * math.sqrt(ref["std"] ** 2 / n_ref + s * s / v.size)
    assert abs(m - ref["mean"]) <= bound, (
        f"{name}: mean {m:.5f} vs reference {ref['mean']:.5f} "
        f"+- {bound:.5f}")
    ratio = s / ref["std"]
    assert 1.0 / STD_RATIO <= ratio <= STD_RATIO, (
        f"{name}: std ratio {ratio:.3f}")
    return m, bound


def _wrap_np(a):
    return np.arctan2(np.sin(a), np.cos(a))


def ekf_statistics(outs):
    """Per-rollout RMSE and mean NEES of the reference's definition
    (scripts/gen_ref_distributions.py), in float64 on the host."""
    x_pre = np.asarray(outs.x_pre, np.float64)
    x_true = np.asarray(outs.x_true, np.float64)
    cov = np.asarray(outs.cov, np.float64)
    e = x_pre - x_true
    e[..., 2] = _wrap_np(e[..., 2])
    rmse = np.sqrt((e[..., 0] ** 2 + e[..., 1] ** 2).mean(axis=1))
    sol = np.linalg.solve(cov, e[..., None])[..., 0]
    nees = np.einsum("bti,bti->bt", e, sol).mean(axis=1)
    return rmse, nees


# --------------------------------------------------------------------------
# 1. EKF Monte-Carlo
# --------------------------------------------------------------------------

def _ekf_oracle(n_steps: int):
    @jax.jit
    def run():
        def body(s, _):
            s, _ = ekf_step_with_noise(CFG, s, jnp.zeros(2), jnp.zeros(3))
            return s, None
        return jax.lax.scan(body, ekf_init(CFG), None, length=n_steps)[0]
    return run()


def ekf_noise_free(batch: int = 8192, n_steps: int = 400,
                   interpret: bool = False, atol: float = 1e-4) -> dict:
    """Kernel with the noise off against the XLA scan oracle: x_hat,
    x_true and cov of every rollout within ``atol``, and zero error."""
    final, err = ekf_fused_rollout(CFG, 0, batch=batch, n_steps=n_steps,
                                   noise_on=False, interpret=interpret)
    ref = _ekf_oracle(n_steps)
    diffs = {name: float(jnp.max(jnp.abs(got - want[None])))
             for name, got, want in (("x_hat", final.x_hat, ref.x_hat),
                                     ("x_true", final.x_true, ref.x_true),
                                     ("cov", final.cov, ref.cov))}
    assert final.x_hat.shape == (batch, 3), final.x_hat.shape
    for name, d in diffs.items():
        assert d <= atol, f"noise-free kernel {name} off by {d}"
    diffs["err"] = float(jnp.max(jnp.abs(err)))
    assert diffs["err"] <= 1e-6, f"noise-free error sum {diffs['err']}"
    return diffs


def ekf_bands(batch: int = 8192, interpret: bool = False) -> dict:
    """Noise on, at the fixture's step count: the kernel's and the XLA
    scan's per-rollout RMSE and mean NEES inside the reference's bands."""
    bands = fixture()
    n_steps, n_ref = bands["ekf_steps"], bands["n_seeds"]
    _, err, nees = ekf_fused_rollout(CFG, 12345, batch=batch,
                                     n_steps=n_steps, with_nees=True,
                                     interpret=interpret)
    out = {}
    out["kernel_rmse"] = check_band(
        "kernel rmse", np.sqrt(np.asarray(err) / n_steps),
        bands["ekf"]["rmse_pos"], n_ref)
    out["kernel_nees"] = check_band(
        "kernel nees", np.asarray(nees) / n_steps,
        bands["ekf"]["mean_nees"], n_ref)
    keys = jax.random.split(jax.random.key(424242), batch)
    _, outs = jax.jit(lambda k: ekf_rollout_batch(CFG, k, n_steps))(keys)
    rmse, mnees = ekf_statistics(outs)
    out["xla_rmse"] = check_band("xla rmse", rmse,
                                 bands["ekf"]["rmse_pos"], n_ref)
    out["xla_nees"] = check_band("xla nees", mnees,
                                 bands["ekf"]["mean_nees"], n_ref)
    return out


def ekf_device_vs_host(batch: int = 64, n_steps: int = 400,
                       atol: float = 1e-4) -> float:
    """The XLA scan on the default device against the host CPU, from the
    same keys (``jax.random`` draws the same bits on every backend)."""
    fn = jax.jit(lambda k: ekf_rollout_batch(CFG, k, n_steps)[1])
    keys = jax.random.split(jax.random.key(7), batch)
    dev = fn(keys)
    host = fn(jax.device_put(keys, jax.devices("cpu")[0]))
    worst = 0.0
    for name in ("x_true", "x_pre", "cov"):
        d = float(np.max(np.abs(np.asarray(getattr(dev, name))
                                - np.asarray(getattr(host, name)))))
        assert d <= atol, f"XLA EKF {name}: device vs host off by {d}"
        worst = max(worst, d)
    return worst


def ekf_timings(batch: int, n_steps: int, reps: int = 5) -> dict:
    """Kernel against ``ekf_rollout_batch``: both return the final states
    and each rollout's summed squared prior position error; their mean
    RMSEs estimate the same quantity and agree within ``K_SE`` combined
    standard errors."""
    def kernel(seed):
        return ekf_fused_rollout(CFG, seed, batch=batch, n_steps=n_steps)

    def xla(keys):
        final, outs = ekf_rollout_batch(CFG, keys, n_steps)
        e = outs.x_pre[..., :2] - outs.x_true[..., :2]
        return final, jnp.sum(e * e, axis=(1, 2))

    keys = jax.random.split(jax.random.key(0), batch)
    (xf, xerr), x_first, x_med = timed(jax.jit(xla), keys, reps=reps)
    x_rmse = np.sqrt(np.asarray(xerr) / n_steps)
    assert np.isfinite(np.asarray(xf.x_hat)).all()
    del xf, xerr, keys
    (kf, kerr), k_first, k_med = timed(jax.jit(kernel), 1, reps=reps)
    k_rmse = np.sqrt(np.asarray(kerr) / n_steps)
    assert kf.x_hat.shape == (batch, 3)
    assert np.isfinite(np.asarray(kf.x_hat)).all()
    assert np.isfinite(np.asarray(kf.cov)).all()
    se = math.sqrt(k_rmse.var() / batch + x_rmse.var() / batch)
    gap = abs(k_rmse.mean() - x_rmse.mean())
    assert gap <= K_SE * se, (
        f"kernel RMSE {k_rmse.mean()} vs XLA {x_rmse.mean()} "
        f"(bound {K_SE * se})")
    steps = batch * n_steps
    report("ekf", f"kernel {batch}x{n_steps}", k_first, k_med,
           f", {steps / k_med:.4e} steps/s, mean RMSE {k_rmse.mean():.5f}")
    report("ekf", f"ekf_rollout_batch {batch}x{n_steps}", x_first, x_med,
           f", {steps / x_med:.4e} steps/s, mean RMSE {x_rmse.mean():.5f}")
    return {"kernel_s": k_med, "xla_s": x_med,
            "kernel_rmse": float(k_rmse.mean()),
            "xla_rmse": float(x_rmse.mean())}


# --------------------------------------------------------------------------
# 2. Particle filter, XLA path
# --------------------------------------------------------------------------

def pf_single(n_particles: int = 1_000_000, n_steps: int = 100,
              reps: int = 3) -> dict:
    """One large filter: tracks the truth (position RMSE of the MAP
    estimate in (0.02, 0.4) m, the band the repo has always used)."""
    cfg = PfConfig(num_particles=n_particles, weight_mode="log",
                   resample_method="hist")
    fn = jax.jit(lambda k: pf_rollout(cfg, k, n_steps))
    (final, outs), first, med = timed(fn, jax.random.key(3), reps=reps)
    e = np.asarray(outs.x_est)[:, :2] - np.asarray(outs.x_true)[:, :2]
    rmse = float(np.sqrt((e ** 2).sum(-1).mean()))
    assert np.isfinite(np.asarray(final.particles)).all()
    assert 0.02 < rmse < 0.4, f"PF {n_particles} RMSE {rmse}"
    report("pf", f"pf_rollout {n_particles}x{n_steps} (log, hist)", first,
           med, f", {n_particles * n_steps / med:.4e} particle-steps/s, "
           f"RMSE {rmse:.4f}, {int(np.asarray(outs.resampled).sum())} "
           f"resamples")
    return {"seconds": med, "rmse": rmse}


def pf_bands(batch: int = 1024) -> dict:
    """Reference-configured filters (1,000 particles) over the fixture's
    steps: RMSE, resample count and mean ESS inside the bands."""
    bands = fixture()
    n_steps, n_ref = bands["pf_steps"], bands["n_seeds"]
    cfg = PfConfig()
    keys = jax.random.split(jax.random.key(31337), batch)
    finals, outs = jax.jit(lambda k: pf_rollout_batch(cfg, k, n_steps))(keys)
    e = np.asarray(outs.x_est)[..., :2] - np.asarray(outs.x_true)[..., :2]
    rmse = np.sqrt((e ** 2).sum(-1).mean(axis=1))
    fires = np.asarray(outs.resampled).sum(axis=1)
    ess = np.concatenate(
        [np.asarray(outs.ess)[:, 1:],
         np.asarray(effective_sample_size(finals.weights))[:, None]],
        axis=1) / cfg.num_particles
    return {"rmse": check_band("pf rmse", rmse, bands["pf"]["rmse_pos"],
                               n_ref),
            "fires": check_band("pf fires", fires,
                                bands["pf"]["fire_count"], n_ref),
            "ess": check_band("pf ess", ess.mean(axis=1),
                              bands["pf"]["mean_ess_frac"], n_ref)}


def pf_batch(batch: int = 1024, n_particles: int = 1000,
             n_steps: int = 100, reps: int = 3) -> dict:
    cfg = PfConfig(num_particles=n_particles)
    keys = jax.random.split(jax.random.key(4), batch)
    fn = jax.jit(lambda k: pf_rollout_batch(cfg, k, n_steps))
    (final, outs), first, med = timed(fn, keys, reps=reps)
    e = np.asarray(outs.x_est)[..., :2] - np.asarray(outs.x_true)[..., :2]
    rmse = float(np.sqrt((e ** 2).sum(-1).mean()))
    assert np.isfinite(np.asarray(final.particles)).all()
    assert 0.02 < rmse < 0.4, f"batched PF RMSE {rmse}"
    report("pf", f"pf_rollout_batch {batch}x{n_particles}x{n_steps}",
           first, med, f", {batch * n_particles * n_steps / med:.4e} "
           f"particle-steps/s, RMSE {rmse:.4f}")
    return {"seconds": med, "rmse": rmse}


# --------------------------------------------------------------------------
# 3. Graph SLAM
# --------------------------------------------------------------------------

def graph_course(n_steps: int = 18, atol: float = 5e-3,
                 reps: int = 3) -> dict:
    """The reference demo course with full guards: per-frame GN iteration
    counts equal on the device and the host CPU, final poses within
    ``atol``, every frame solved."""
    from slamsim.slam import (SlamSceneConfig, reference_course_config,
                              slam_rollout)

    cfg = reference_course_config(n_steps, guard="full")
    scene = SlamSceneConfig()

    def run(key):
        _, poses, frames = slam_rollout(scene, cfg, key, n_steps)
        return poses, frames.gn_iters, frames.is_calc

    fn = jax.jit(run)
    key = jax.random.key(0)
    (poses, iters, ok), first, med = timed(fn, key, reps=reps)
    h_poses, h_iters, h_ok = fn(jax.device_put(key, jax.devices("cpu")[0]))
    assert np.asarray(ok).all() and np.asarray(h_ok).all()
    assert np.array_equal(np.asarray(iters), np.asarray(h_iters)), (
        f"GN iterations differ: {np.asarray(iters)} vs "
        f"{np.asarray(h_iters)}")
    diff = float(np.max(np.abs(np.asarray(poses) - np.asarray(h_poses))))
    assert diff <= atol, f"course poses device vs host off by {diff}"
    report("graph", f"reference course ({n_steps} frames, full guards)",
           first, med, f", {int(np.asarray(iters).sum())} GN iterations, "
           f"poses vs host CPU max|d| {diff:.2e}")
    return {"seconds": med, "pose_diff": diff,
            "gn_iters": int(np.asarray(iters).sum())}


def _scan_config(n_poses: int, n_landmarks: int):
    from slamsim.models.scan_sensor import ScanConfig
    from slamsim.slam import GraphConfig

    return GraphConfig(
        max_times=n_poses, num_landmarks=n_landmarks, max_gn_iters=10,
        scan=ScanConfig(range_m=15.0, angle_rad=math.radians(80.0),
                        dist_gain=0.05, dir_sigma=math.radians(2.0),
                        orient_sigma=math.radians(2.0)),
        exact_jacobians=True)


def _large_scene(n_poses, n_landmarks, radius, window, scan_chunk=None,
                 seed=0):
    from slamsim.slam import make_large_scene, window_pairs

    cfg = _scan_config(n_poses, n_landmarks)
    pt, po, obs = make_large_scene(cfg, jax.random.key(seed), n_poses,
                                   n_landmarks, radius=radius,
                                   odom_noise=0.1, scan_chunk=scan_chunk)
    el = window_pairs(np.asarray(obs.valid), window=window)
    rel_odom = po[1:] - po[:-1]
    rel_odom = rel_odom.at[:, 2].set(wrap_angle(rel_odom[:, 2]))
    return cfg, pt, po, obs, el, rel_odom


def graph_solvers(n_poses: int = 4096, n_landmarks: int = 512,
                  window: int = 40) -> dict:
    """One assembled banded system solved by tridiag, CR and CG: the two
    direct solves agree to 1e-3 and leave relative residuals under
    1e-3, CG under 1e-2; the full GN solve beats odometry twofold."""
    from slamsim.slam import graph_solve_banded
    from slamsim.slam.cyclic import banded_solve_cr_flat
    from slamsim.slam.large import (add_odometry_chain_flat,
                                    assemble_banded_flat,
                                    build_edge_blocks, cg_solve_flat,
                                    make_banded_matvec_flat)
    from slamsim.slam.tridiag import banded_solve_tridiag_flat

    # Landmark sightings dense relative to the course (radius 0.05 n),
    # so the solve corrects global drift and "beats odometry" means
    # something.
    cfg, pt, po, obs, el, rel_odom = _large_scene(
        n_poses, n_landmarks, 0.05 * n_poses, window)

    # Arrays ride as arguments: closed over, they would be constants for
    # XLA to fold at compile time.
    @jax.jit
    def solvers(po, obs, el, rel_odom):
        blocks = build_edge_blocks(cfg, po, obs, el, omega_poses=po)
        h_flat, b_flat, _ = assemble_banded_flat(cfg, blocks, el, n_poses,
                                                 window)
        h_flat, b_flat = add_odometry_chain_flat(
            h_flat, b_flat, po, rel_odom, (100.0, 100.0, 100.0))
        d_t = banded_solve_tridiag_flat(h_flat, -b_flat, window)
        d_r = banded_solve_cr_flat(h_flat, -b_flat, window)
        d_c, _ = cg_solve_flat(h_flat, -b_flat, window, 400, 1e-10)
        mv = make_banded_matvec_flat(h_flat, window)

        def relres(x):
            r = mv(x.T) + b_flat
            return jnp.sqrt(jnp.sum(r * r) / jnp.sum(b_flat * b_flat))

        scale = jnp.max(jnp.abs(d_t))
        return (jnp.max(jnp.abs(d_t - d_r)) / scale,
                jnp.max(jnp.abs(d_t - d_c)) / scale,
                relres(d_t), relres(d_r), relres(d_c))

    dtr, dtc, r_t, r_r, r_c = (float(x) for x in solvers(po, obs, el,
                                                          rel_odom))
    assert dtr < 1e-3, f"tridiag vs CR direct solves differ: {dtr}"
    assert r_t < 1e-3 and r_r < 1e-3, f"direct residuals {r_t}, {r_r}"
    assert r_c < 1e-2, f"CG residual {r_c}"
    # CG's distance from the direct solve is bounded only by
    # cond(H) * residual: this catches gross layout or sign bugs only.
    assert dtc < 0.5, f"tridiag vs CG solutions differ: {dtc}"

    res = jax.jit(lambda po, obs, el, rel_odom: graph_solve_banded(
        cfg, po, obs, el, band=window, rel_odom=rel_odom,
        odom_info=(100.0, 100.0, 100.0), solver="tridiag",
        stall_ratio=0.5, delta_tol=1e-6 * n_poses))(po, obs, el, rel_odom)
    err_t = float(jnp.sqrt(jnp.mean(
        jnp.sum((res.poses[:, :2] - pt[:, :2]) ** 2, -1))))
    err_o = float(jnp.sqrt(jnp.mean(
        jnp.sum((po[:, :2] - pt[:, :2]) ** 2, -1))))
    assert err_t < 0.5 * err_o, f"solve RMSE {err_t} vs odometry {err_o}"
    log(f"[graph] {n_poses}-pose solvers: tridiag vs CR {dtr:.1e}, vs CG "
        f"{dtc:.1e}, relres {r_t:.1e}/{r_r:.1e}/{r_c:.1e}; GN RMSE "
        f"{err_t:.4f} vs odometry {err_o:.4f}")
    return {"tridiag_vs_cr": dtr, "tridiag_vs_cg": dtc,
            "relres": (r_t, r_r, r_c), "rmse": err_t, "odom_rmse": err_o}


def graph_large(n_poses: int = 100_000, n_landmarks: int = 1000,
                window: int = 40, scan_chunk: int | None = 10_000,
                reps: int = 2) -> dict:
    """The banded solve in the bench's BASELINE geometry (radius 0.3 n):
    tridiag with factor reuse and the stall stop.  Checks finite poses
    and at least one GN iteration."""
    from slamsim.slam import graph_solve_banded

    cfg, pt, po, obs, el, rel_odom = _large_scene(
        n_poses, n_landmarks, 0.3 * n_poses, window, scan_chunk)

    def solve(p, obs, el, rel_odom):
        res = graph_solve_banded(cfg, p, obs, el, band=window,
                                 rel_odom=rel_odom,
                                 odom_info=(100.0, 100.0, 100.0),
                                 solver="tridiag", stall_ratio=0.5,
                                 delta_tol=1e-6 * n_poses)
        return res.poses, res.gn_iters

    (poses, iters), first, med = timed(jax.jit(solve), po, obs, el,
                                       rel_odom, reps=reps)
    assert np.isfinite(np.asarray(poses)).all()
    assert int(iters) >= 1
    err = float(jnp.sqrt(jnp.mean(jnp.sum((poses[:, :2] - pt[:, :2]) ** 2,
                                          -1))))
    err_o = float(jnp.sqrt(jnp.mean(jnp.sum((po[:, :2] - pt[:, :2]) ** 2,
                                            -1))))
    report("graph", f"banded solve {n_poses} poses / {n_landmarks} "
           f"landmarks ({el.t_b.shape[0]} edges)", first, med,
           f", {int(iters)} GN iterations, RMSE {err:.4f} (odometry "
           f"{err_o:.4f})")
    return {"seconds": med, "gn_iters": int(iters), "rmse": err,
            "odom_rmse": err_o}


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------

def four_ekf_sweeps(devices, batch: int = 8_388_608, n_steps: int = 100,
                    interpret: bool = False) -> dict:
    """Rollout-sharded sweeps against one-device calls for the same keys
    or seed: the fused sweep per rollout bit for bit (the kernel keys
    its noise by global rollout index), the XLA sweep's final states and
    its RMSE to reduction order."""
    from slamsim.parallel import (make_mesh, sharded_ekf_fused_sweep,
                                  sharded_ekf_sweep)

    mesh = make_mesh(n_rollout=len(devices), devices=devices)
    out = {}

    def sharded_fused(seed):
        return sharded_ekf_fused_sweep(CFG, mesh, seed, batch=batch,
                                       n_steps=n_steps, interpret=interpret)

    (sf, serr, srmse), first, med = timed(jax.jit(sharded_fused), 5)
    report("four", f"sharded_ekf_fused_sweep {batch}x{n_steps}", first, med)
    with jax.default_device(devices[0]):
        of, oerr = jax.jit(lambda s: ekf_fused_rollout(
            CFG, s, batch=batch, n_steps=n_steps, interpret=interpret))(5)
    for name, a, b in (("x_hat", sf.x_hat, of.x_hat),
                       ("cov", sf.cov, of.cov), ("err", serr, oerr)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (
            f"sharded fused sweep {name} differs from one device")
    one_rmse = math.sqrt(float(np.asarray(oerr, np.float64).sum())
                         / (batch * n_steps))
    assert abs(float(srmse) - one_rmse) <= 1e-5 * one_rmse
    out["fused_rmse"] = (float(srmse), one_rmse)
    del sf, serr, of, oerr

    keys = jax.random.split(jax.random.key(11), batch)

    def sharded_xla(k):
        x_true, x_pre, rmse = sharded_ekf_sweep(CFG, mesh, k, n_steps)
        return x_true[:, -1], x_pre[:, -1], rmse

    def one_xla(k):
        _, outs = ekf_rollout_batch(CFG, k, n_steps)
        e = outs.x_pre[..., :2] - outs.x_true[..., :2]
        return (outs.x_true[:, -1], outs.x_pre[:, -1],
                jnp.sqrt(jnp.mean(jnp.sum(e * e, -1))))

    (st, sp, sr), first, med = timed(jax.jit(sharded_xla), keys)
    report("four", f"sharded_ekf_sweep {batch}x{n_steps}", first, med)
    with jax.default_device(devices[0]):
        ot, op, orr = jax.jit(one_xla)(jax.device_put(keys, devices[0]))
    d = max(float(np.max(np.abs(np.asarray(st) - np.asarray(ot)))),
            float(np.max(np.abs(np.asarray(sp) - np.asarray(op)))))
    bitwise = d == 0.0
    assert d <= 1e-5, f"sharded XLA sweep final states off by {d}"
    rel = abs(float(sr) - float(orr)) / float(orr)
    assert rel <= 1e-5, f"sharded XLA sweep RMSE off by {rel} (relative)"
    log(f"[four] EKF sweeps vs one device: fused bit-equal per rollout, "
        f"RMSE {float(srmse):.6f} vs {one_rmse:.6f}; XLA final states "
        f"max|d| {d:.1e} (bitwise {bitwise}), RMSE rel diff {rel:.1e}")
    out.update(xla_state_diff=d, xla_bitwise=bitwise, xla_rmse_rel=rel)
    return out


def four_pf_step(devices, n_particles: int = 1_000_000) -> dict:
    """One particle-sharded step against ``pf_step`` from a degenerate
    state (the resample fires): particles within 1e-5, MAP estimate
    within 1e-5, weights within a relative 1e-3.  The weights'
    normalizer sums in another order; at log-weights of order 1e3 a few
    f32 ulps of it are ~1e-4 of each weight."""
    from slamsim.filters import PfState, pf_step
    from slamsim.parallel import make_mesh, sharded_pf_step

    cfg = PfConfig(num_particles=n_particles, weight_mode="log",
                   resample_method="hist")
    mesh = make_mesh(n_rollout=1, n_particle=len(devices), devices=devices)
    k1, k2 = jax.random.split(jax.random.key(21))
    x0 = jnp.asarray(cfg.x0, jnp.float32)
    particles = x0 + 0.3 * jax.random.normal(k1, (n_particles, 3))
    weights = jax.nn.softmax(6.0 * jax.random.normal(k2, (n_particles,)))
    state = PfState(x_true=x0, particles=particles, weights=weights)
    assert float(effective_sample_size(weights)) < (
        n_particles * cfg.ess_threshold_frac)
    key = jax.random.key(22)
    (s_state, s_est), first, med = timed(
        jax.jit(lambda s, k: sharded_pf_step(cfg, mesh, s, k)), state, key)
    report("four", f"sharded_pf_step {n_particles} particles", first, med)
    with jax.default_device(devices[0]):
        o_state, o_out = jax.jit(lambda s, k: pf_step(cfg, s, k))(
            jax.device_put(state, devices[0]), key)
    assert bool(o_out.resampled)
    dp = float(np.max(np.abs(np.asarray(s_state.particles)
                             - np.asarray(o_state.particles))))
    w_s = np.asarray(s_state.weights, np.float64)
    w_o = np.asarray(o_state.weights, np.float64)
    dw = float(np.max(np.abs(w_s - w_o) / np.maximum(w_o, 1e-30)))
    de = float(np.max(np.abs(np.asarray(s_est) - np.asarray(o_out.x_est))))
    log(f"[four] PF step vs pf_step: particles max|d| {dp:.1e}, weights "
        f"max rel {dw:.1e}, estimate max|d| {de:.1e}")
    assert dp <= 1e-5, f"sharded PF particles off by {dp}"
    assert dw <= 1e-3, f"sharded PF weights off by {dw} (relative)"
    assert de <= 1e-5, f"sharded PF estimate off by {de}"
    return {"particles": dp, "weights_rel": dw, "estimate": de}


def four_graph(devices, n_poses: int = 100_000, n_landmarks: int = 1000,
               window: int = 40, scan_chunk: int | None = 10_000,
               atol: float = 5e-3) -> dict:
    """One pose-sharded tridiagonal GN iteration against the same
    iteration on one device, poses within ``atol``."""
    from slamsim.parallel import make_mesh, sharded_gn_iteration

    cfg, _, po, obs, el, rel_odom = _large_scene(
        n_poses, n_landmarks, 0.3 * n_poses, window, scan_chunk)

    def iteration(mesh):
        return jax.jit(lambda p, obs, el, rel_odom: sharded_gn_iteration(
            cfg, mesh, p, obs, el, window, rel_odom=rel_odom,
            solver="sharded_tridiag")[0])

    mesh4 = make_mesh(n_rollout=len(devices), devices=devices)
    p4, first, med = timed(iteration(mesh4), po, obs, el, rel_odom)
    report("four", f"sharded_gn_iteration(sharded_tridiag) {n_poses} "
           f"poses", first, med)
    mesh1 = make_mesh(n_rollout=1, devices=devices[:1])
    p1 = iteration(mesh1)(po, obs, el, rel_odom)
    d = float(np.max(np.abs(np.asarray(p4) - np.asarray(p1))))
    assert d <= atol, f"sharded tridiag iteration off by {d}"
    log(f"[four] pose-sharded GN iteration vs one device: max|d| {d:.1e}")
    return {"pose_diff": d}


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four GPUs")
    args = parser.parse_args(argv)
    count = 4 if args.four_cards else 1

    devices = runtime.require_gpu(jax.devices(), count)
    runtime.configure_compile_cache(ROOT)
    cards = runtime.card_info()
    _CARD[0] = cards[0]
    for line in cards[:count]:
        log(f"card: {line}")
    log(f"jax {jax.__version__}; devices: {devices}")

    t0 = time.perf_counter()
    if args.four_cards:
        four_ekf_sweeps(devices)
        four_pf_step(devices)
        four_graph(devices)
    else:
        log(f"[ekf] noise-free kernel vs scan oracle: {ekf_noise_free()}")
        log(f"[ekf] noise-on bands (mean, bound): {ekf_bands()}")
        log(f"[ekf] XLA scan device vs host CPU max|d|: "
            f"{ekf_device_vs_host():.2e}")
        ekf_timings(8192, 400, reps=10)
        ekf_timings(8_388_608, 100, reps=5)
        pf_single()
        log(f"[pf] reference bands (mean, bound): {pf_bands()}")
        pf_batch()
        graph_course()
        graph_solvers()
        graph_large()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s | "
        f"{_CARD[0]}")
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
