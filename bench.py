#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline (BASELINE.json north star): batched EKF-SLAM sim steps/sec on
one GPU, from the fused Triton kernel at 8M rollouts x 1600 steps;
``vs_baseline`` is the ratio against the 1e6 target.  Every other cell
goes to stderr, one line each, naming the platform, the device kind and
the card's name and power limit.

Before any timing, the on-device gates of ``chip_smoke.py`` run (kernel
against the scan oracle, the reference's distributional bands, the
graph solvers); a failed gate aborts the bench with a non-zero exit.
Every timing is the median wall time of calls fenced by
``block_until_ready``; compilation is the first, untimed call.  The
bench refuses to run where JAX sees no GPU.
"""

import contextlib
import json
import math
import pathlib
import sys
import time

import jax

import chip_smoke
from slamsim.utils import runtime
from slamsim.utils.profiling import timed

ROOT = pathlib.Path(__file__).resolve().parent
_TAG = [""]


def line(msg: str) -> None:
    print(f"# {msg} | {_TAG[0]}", file=sys.stderr, flush=True)


def bench_ekf_kernel(batch=8_388_608, steps=1600, reps=5):
    """Fused Triton kernel (ops/ekf_pallas.py), steps/s."""
    from slamsim.filters import EkfConfig
    from slamsim.ops import ekf_fused_rollout

    cfg = EkfConfig()
    fn = jax.jit(lambda s: ekf_fused_rollout(cfg, s, batch=batch,
                                             n_steps=steps))
    return batch * steps / timed(fn, 1, reps=reps)


def bench_ekf_scan(batch=8192, steps=400, reps=5):
    """XLA lax.scan path, steps/s."""
    from slamsim.filters import EkfConfig, ekf_rollout_batch

    cfg = EkfConfig()
    keys = jax.random.split(jax.random.key(0), batch)
    fn = jax.jit(lambda k: ekf_rollout_batch(cfg, k, steps)[0])
    return batch * steps / timed(fn, keys, reps=reps)


def bench_pf(particles=100_000, steps=100, reps=3):
    """One filter, XLA path (log weights, hist resample), particle-steps/s."""
    from slamsim.filters import PfConfig, pf_rollout

    cfg = PfConfig(num_particles=particles, weight_mode="log",
                   resample_method="hist")
    fn = jax.jit(lambda k: pf_rollout(cfg, k, steps))
    return particles * steps / timed(fn, jax.random.key(0), reps=reps)


def bench_pf_batch(batch=1024, particles=1000, steps=400, reps=3):
    """B independent filters, vmapped XLA path, particle-steps/s."""
    from slamsim.filters import PfConfig, pf_rollout_batch

    cfg = PfConfig(num_particles=particles, weight_mode="log",
                   resample_method="hist")
    keys = jax.random.split(jax.random.key(0), batch)
    fn = jax.jit(lambda k: pf_rollout_batch(cfg, k, steps))
    return batch * particles * steps / timed(fn, keys, reps=reps)


def bench_graph(n_steps=18, guard="full", reps=3):
    """The reference demo course itself: 18 frames, per-frame GN
    re-estimation of the whole trajectory (graph_based_slam.py runs this
    at 0.5 Hz = 36 s wall).  ``guard="full"`` matches reference semantics
    (true det + SVD cond every updateEstPose, graph_based_slam.py:494-495);
    "cheap" uses slogdet + a diagonal bound.  Seconds."""
    from slamsim.slam import (SlamSceneConfig, reference_course_config,
                              slam_rollout)

    cfg = reference_course_config(n_steps, guard=guard)
    scene = SlamSceneConfig()
    fn = jax.jit(lambda k: slam_rollout(scene, cfg, k, n_steps)[1])
    return timed(fn, jax.random.key(0), reps=reps)


def bench_graph_large(n_poses=10_000, n_landmarks=1000, window=40,
                      scan_chunk=None, radius_frac=0.3, reps=3):
    """BASELINE config 5 and its scale-ups: banded solve latency,
    ``(seconds, edges, gn_iters)``."""
    from slamsim.slam import graph_solve_banded

    cfg, _, po, obs, el, rel_odom = chip_smoke._large_scene(
        n_poses, n_landmarks, radius_frac * n_poses, window, scan_chunk)

    def fn(p, obs, el, rel_odom):
        # tridiag + factor reuse (exact Jacobians + frozen Omega -> H
        # constant: factor once, substitute per GN iteration) + stall
        # stop at the f32 refinement floor.
        res = graph_solve_banded(cfg, p, obs, el, band=window,
                                 rel_odom=rel_odom,
                                 odom_info=(100.0, 100.0, 100.0),
                                 solver="tridiag", stall_ratio=0.5,
                                 delta_tol=1e-6 * n_poses)
        return res.poses, res.gn_iters

    jfn = jax.jit(fn)
    dt = timed(jfn, po, obs, el, rel_odom, reps=reps)
    return dt, el.t_b.shape[0], int(jfn(po, obs, el, rel_odom)[1])


def run_gates():
    t0 = time.perf_counter()
    line(f"gate OK: noise-free kernel == XLA scan "
         f"{chip_smoke.ekf_noise_free()}")
    line(f"gate OK: EKF reference bands {chip_smoke.ekf_bands()}")
    line(f"gate OK: PF reference bands {chip_smoke.pf_bands()}")
    line(f"gate OK: graph solvers {chip_smoke.graph_solvers()}; all gates "
         f"in {time.perf_counter() - t0:.0f} s")


def main():
    dev = runtime.require_gpu(jax.devices())[0]
    runtime.configure_compile_cache(ROOT)
    card = runtime.card_info()[0]
    _TAG[0] = f"{dev.platform} {dev.device_kind} | {card}"
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the JSON only
        run_gates()

    ekf_rate = bench_ekf_kernel()
    line(f"EKF fused kernel 8388608x1600: {ekf_rate:.4e} steps/s")
    line(f"EKF fused kernel 8192x400: "
         f"{bench_ekf_kernel(batch=8192, steps=400, reps=10):.4e} steps/s")
    line(f"EKF XLA scan 8192x400: {bench_ekf_scan():.4e} steps/s")
    for n, steps in ((100_000, 100), (100_000, 400), (1_000_000, 400),
                     (2_097_152, 400)):
        line(f"PF XLA {n}x{steps} (log, hist): "
             f"{bench_pf(n, steps):.4e} particle-steps/s")
    for b, n in ((1024, 1000), (8192, 1000), (128, 10_000),
                 (1024, 10_000)):
        line(f"PF batched XLA {b}x{n}x400 (log, hist): "
             f"{bench_pf_batch(b, n):.4e} particle-steps/s")
    for guard in ("full", "cheap"):
        line(f"reference demo course (18 frames, {guard} guards; 36 s in "
             f"the reference): {bench_graph(guard=guard) * 1e3:.3f} ms")
    for n, lm, chunk, rf in ((10_000, 1000, None, 0.3),
                             (100_000, 1000, 10_000, 0.3),
                             (1_000_000, 100, 10_000, 0.05)):
        dt, n_edges, iters = bench_graph_large(
            n_poses=n, n_landmarks=lm, scan_chunk=chunk, radius_frac=rf)
        line(f"graph solve {n} poses / {lm} landmarks ({n_edges} edges): "
             f"{dt:.4f} s, {iters} GN iterations")

    target = 1.0e6
    print(json.dumps({
        "metric": "batched EKF-SLAM sim steps/sec/chip",
        "value": ekf_rate,
        "unit": "steps/s",
        "vs_baseline": ekf_rate / target,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "card": card},
    }))
    return 0 if math.isfinite(ekf_rate) else 1


if __name__ == "__main__":
    sys.exit(main())
