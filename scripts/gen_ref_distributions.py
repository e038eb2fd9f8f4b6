#!/usr/bin/env python
"""Generate the distributional-fidelity fixture from the LIVE reference.

Runs the executing reference (/root/reference) EKF and PF demos headless
for N independent seeds and records per-seed summary statistics into
``tests/fixtures/ref_distributions.json``.  The committed fixture is the
ground truth for ``tests/test_distributional.py`` (SURVEY.md §4.2's
"*distributional* match ... RMSE/NEES ... over N seeded rollouts"
clause): numpy MT19937 cannot be bit-matched from JAX, so
fidelity at the statistics level is asserted against bands measured from
the reference itself, not from the hand-written oracles.

Statistics (identical formulas on the slamsim side):
  EKF (120 steps, seed-per-run):
    rmse_pos   sqrt(mean_t ||x_pre[t,:2] - x_true[t,:2]||^2)
               (x_pre is what main_ekf returns/plots,
                extended_kalman_filter.py:130)
    mean_nees  mean_t e_t' P_t^{-1} e_t, e = x_pre - x_true (yaw wrapped),
               P the returned posterior covariance
  PF (60 steps, NP=1000):
    rmse_pos   from the returned MAP-particle estimate
               (particle_filter.py:115-117)
    fire_count number of ESS-gate resample firings (rand draws at :214)
    mean_ess_frac  mean_t ESS(pw_t)/NP of the post-step weights (the next
               step's gate input, :200-224)

  Graph SLAM (18-frame demo course + a 6-frame fast prefix - the
  native-key noise wiring of slam_rollout is exactly what the
  recorded-draw replay tests bypass):
    rmse_pos       final-course sqrt(mean ||est - actual||^2 over
                   positions at OBSERVED times) - the poses the
                   reference plots (graph_based_slam.py:441-449)
    total_gn_iters sum over frames of the GN loop count
                   (graph_based_slam.py:706-711), per-frame capped at
                   GraphConfig.max_gn_iters to match the slamsim cap
    calc_failures  frames whose det/cond guard failed (isCalc False)

Usage: python scripts/gen_ref_distributions.py [N_SEEDS] [--sections a,b]
(~5-10 min for the PF side; run once, commit the fixture.)
``--sections ekf,pf,graph`` regenerates only the named sections and
merges them into the existing fixture; the slamsim config snapshot
(``gen_config``, asserted fresh by test_distributional.py) is always
refreshed.
"""

import contextlib
import io
import json
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REF_DIR = pathlib.Path("/root/reference")
OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / \
    "fixtures" / "ref_distributions.json"

def _parse_args(argv):
    """(n_seeds, sections) from [N_SEEDS] [--sections=a,b]."""
    args = [a for a in argv if not a.startswith("--")]
    sections = ("ekf", "pf", "graph")
    for f in argv:
        if f.startswith("--sections"):
            sections = tuple(f.split("=", 1)[1].split(","))
    return (int(args[0]) if args else 100), sections


N_SEEDS, SECTIONS = 100, ("ekf", "pf", "graph")
EKF_STEPS = 120
PF_STEPS = 60
GRAPH_FRAMES = 18
GRAPH_FRAMES_FAST = 6
GRAPH_ITER_CAP = 50  # = GraphConfig.max_gn_iters (per-frame cap)


def _mlab_bivariate_normal(X, Y, sigmax=1.0, sigmay=1.0, mux=0.0, muy=0.0,
                           sigmaxy=0.0):
    Xmu = X - mux
    Ymu = Y - muy
    rho = sigmaxy / (sigmax * sigmay)
    z = (Xmu ** 2 / sigmax ** 2 + Ymu ** 2 / sigmay ** 2
         - 2 * rho * Xmu * Ymu / (sigmax * sigmay))
    denom = 2 * np.pi * sigmax * sigmay * np.sqrt(1 - rho ** 2)
    return np.exp(-z / (2 * (1 - rho ** 2))) / denom


def import_reference():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.mlab as mlab
    if not hasattr(mlab, "bivariate_normal"):
        mlab.bivariate_normal = _mlab_bivariate_normal
    old_flag = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(REF_DIR))
    try:
        import extended_kalman_filter as ekf_mod
        import graph_based_slam as gbs_mod
        import particle_filter as pf_mod
    finally:
        sys.path.remove(str(REF_DIR))
        sys.dont_write_bytecode = old_flag
    return ekf_mod, pf_mod, gbs_mod


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def run_ekf_seed(ekf_mod, seed):
    np.random.seed(seed)
    rekf = ekf_mod.ExtendedKalmanFilter(100)
    sq = []
    nees = []
    for _ in range(EKF_STEPS):
        x_true, x_dr, z, x_pre, P = rekf.main_ekf()
        e = (x_pre - x_true).ravel()
        e[2] = wrap(e[2])
        sq.append(float(e[0] ** 2 + e[1] ** 2))
        nees.append(float(e @ np.linalg.solve(P, e)))
    return {"rmse_pos": float(np.sqrt(np.mean(sq))),
            "mean_nees": float(np.mean(nees))}


def run_pf_seed(pf_mod, seed):
    np.random.seed(seed)
    rpf = pf_mod.ParticleFilter(100)

    fire = [0]
    orig_rand = np.random.rand

    def counting_rand(*a):
        fire[0] += 1
        return orig_rand(*a)

    np.random.rand = counting_rand
    sq = []
    ess_frac = []
    try:
        for _ in range(PF_STEPS):
            lm, x_true, x_est, px, Q, max_idx, max_w = rpf.main_pf()
            e = (np.asarray(x_est).ravel()[:2]
                 - np.asarray(x_true).ravel()[:2])
            sq.append(float(e @ e))
            pw = np.asarray(rpf._ParticleFilter__pw).ravel()
            ess_frac.append(float(1.0 / np.sum(pw ** 2) / pw.size))
    finally:
        np.random.rand = orig_rand
    return {"rmse_pos": float(np.sqrt(np.mean(sq))),
            "fire_count": fire[0],
            "mean_ess_frac": float(np.mean(ess_frac))}


def run_graph_seed(gbs_mod, seed, n_frames):
    """One noise-driven pass of the reference demo course.

    Mirrors the animation callback (graph_based_slam.py:931-975): per
    frame one move + a full-trajectory estimateOpticalTrajectory.  The
    per-frame GN loop count is capped at GRAPH_ITER_CAP to match
    GraphConfig.max_gn_iters (a runaway reference loop past the cap
    raises and the seed is dropped with a warning).
    """
    np.random.seed(seed)
    x_base = np.array([[10.0], [0.0], [np.deg2rad(90.0)]])
    with contextlib.redirect_stdout(io.StringIO()):  # "Loop(n)" spam
        rbt = gbs_mod.Robot(x_base, 2.0, gbs_mod.SCN_SENS_RANGE_m,
                            gbs_mod.SCN_SENS_ANGLE_rps,
                            np.asarray(gbs_mod.LAND_MARKS, float))
        est = rbt._Robot__mTrjEst
        orig_update = est.updateEstPose
        frame_calls = [0]

        def capped_update():
            frame_calls[0] += 1
            if frame_calls[0] > 4 * GRAPH_ITER_CAP:
                raise RuntimeError(f"GN runaway at seed {seed}")
            return orig_update()

        est.updateEstPose = capped_update
        frame_iters, failures = [], 0
        for _ in range(n_frames):
            rbt.move(gbs_mod.VEL_mps, gbs_mod.OMEGA_rps)
            frame_calls[0] = 0
            rbt.estimateOpticalTrajectory()
            frame_iters.append(int(rbt._Robot__loopCnt))
            if not rbt._Robot__isCalc:
                failures += 1
    poses_est = est._TrajectoryEstimator__mPosesEst
    is_obs = est._TrajectoryEstimator__mIsObs
    actu = rbt._Robot__mPosesActu
    sq = [float((pe[0, 0] - pa[0, 0]) ** 2 + (pe[1, 0] - pa[1, 0]) ** 2)
          for pe, pa, o in zip(poses_est, actu, is_obs) if o]
    return {"rmse_pos": float(np.sqrt(np.mean(sq))),
            "total_gn_iters": int(sum(min(i, GRAPH_ITER_CAP)
                                      for i in frame_iters)),
            "max_frame_iters": int(max(frame_iters)),
            "calc_failures": failures}


def slamsim_config_snapshot():
    """Snapshot of the slamsim configs the distributional test runs with.

    Committed into the fixture and asserted equal to the LIVE defaults by
    test_distributional.py::test_fixture_config_is_fresh - a default
    drift (noise stds, NP, course geometry) invalidates the bands loudly
    instead of silently.
    """
    from dataclasses import asdict

    from slamsim.filters import EkfConfig, PfConfig
    from slamsim.slam import SlamSceneConfig, reference_course_config

    snap = {
        "ekf": asdict(EkfConfig()),
        "pf": asdict(PfConfig()),
        "graph": asdict(reference_course_config(GRAPH_FRAMES)),
        "graph_fast": asdict(reference_course_config(GRAPH_FRAMES_FAST)),
        "scene": asdict(SlamSceneConfig()),
    }
    return json.loads(json.dumps(snap))  # tuples -> lists, like the file


def summarize(rows):
    out = {}
    for k in rows[0]:
        v = np.array([r[k] for r in rows], float)
        out[k] = {"mean": float(v.mean()), "std": float(v.std(ddof=1)),
                  "min": float(v.min()), "max": float(v.max()),
                  "q10": float(np.quantile(v, 0.10)),
                  "q90": float(np.quantile(v, 0.90))}
    return out


def main():
    ekf_mod, pf_mod, gbs_mod = import_reference()
    fixture = json.loads(OUT.read_text()) if OUT.exists() else {}
    fixture.setdefault("n_seeds", N_SEEDS)
    print(f"running live reference: {N_SEEDS} seeds, sections "
          f"{SECTIONS}", flush=True)

    if "ekf" in SECTIONS:
        ekf_rows = [run_ekf_seed(ekf_mod, 1000 + s)
                    for s in range(N_SEEDS)]
        fixture.update(ekf_steps=EKF_STEPS, ekf=summarize(ekf_rows),
                       ekf_rows=ekf_rows, n_seeds=N_SEEDS)
        print("EKF done", flush=True)
    if "pf" in SECTIONS:
        pf_rows = []
        for s in range(N_SEEDS):
            pf_rows.append(run_pf_seed(pf_mod, 2000 + s))
            if (s + 1) % 10 == 0:
                print(f"PF {s + 1}/{N_SEEDS}", flush=True)
        fixture.update(pf_steps=PF_STEPS, pf=summarize(pf_rows),
                       pf_rows=pf_rows, n_seeds=N_SEEDS)
    if "graph" in SECTIONS:
        for name, frames in (("graph", GRAPH_FRAMES),
                             ("graph_fast", GRAPH_FRAMES_FAST)):
            rows = []
            for s in range(N_SEEDS):
                try:
                    rows.append(run_graph_seed(gbs_mod, 3000 + s, frames))
                except RuntimeError as e:
                    print(f"  dropped: {e}", flush=True)
                if (s + 1) % 10 == 0:
                    print(f"{name} {s + 1}/{N_SEEDS}", flush=True)
            fixture[name] = summarize(rows)
            fixture[name]["n_seeds"] = len(rows)
            fixture[name + "_rows"] = rows
            fixture[name + "_frames"] = frames

    fixture["gen_config"] = slamsim_config_snapshot()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(fixture, indent=1))
    print(f"wrote {OUT}")
    for side in ("ekf", "pf", "graph", "graph_fast"):
        if side not in fixture:
            continue
        for k, st in fixture[side].items():
            if not isinstance(st, dict):
                continue
            print(f"  {side}.{k}: mean={st['mean']:.4f} std={st['std']:.4f}"
                  f" [{st['min']:.4f}, {st['max']:.4f}]")


if __name__ == "__main__":
    N_SEEDS, SECTIONS = _parse_args(sys.argv[1:])
    main()
