"""Benchmark harness: ALL FIVE BASELINE.json configs with enforced ATE
bounds, plus the 20k-node global PGO.

Prints exactly ONE primary JSON line to stdout (config #1 keyframes/sec);
every other config reports to stderr, and every config is written to
``BENCH_DETAIL.json`` with the device it ran on (JAX platform and
``device_kind``, the ``nvidia-smi`` name and power limit).  A config whose
ATE exceeds its bound prints ``ATE-BOUND-VIOLATED`` and zeroes its
vs_baseline contribution; the process exits non-zero when any config raised
or broke its bound.

Baseline note: the reference repo publishes no numbers (BASELINE.md); the
ICRA'13 SRBA paper reports per-KF cost of "milliseconds to tens of ms" on
2012-era x86 for comparable synthetic range-bearing worlds at these tree
depths.  ``vs_baseline`` therefore uses the midpoint of that claim (10
ms/KF => 100 KF/s) as the stand-in reference throughput.

Run: python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

REF_KF_PER_SEC = 100.0  # stand-in; see module docstring / BASELINE.md

# Per-config ATE bounds (meters), set to ~2x the ATE each config reached
# when they were calibrated (config1 0.082, config2 0.091, config3 0.184,
# config4 0.019, config5 0.869) so real regressions trip them and noise
# does not.  config3/config5 keep their long-standing accuracy targets
# (tighter than 2x): 0.25 and 1.0 are the quality claims this project is
# held to.
ATE_BOUNDS = {
    "config1_rb2d": 0.16,
    "config2_rb3d": 0.18,
    "config3_stereo": 0.25,
    "config4_graphslam": 0.04,
    "config5_mono5k": 1.00,
}

DETAIL: list = []


def _record(entry: dict) -> dict:
    """Append one result to the detail file's list, stamped with the
    device it ran on."""
    from srba_tpu.utils.devices import device_record

    entry = {**entry, **device_record()}
    DETAIL.append(entry)
    return entry


def _report(name: str, kf_per_sec: float, ate: float, extra: str = ""):
    bound = ATE_BOUNDS[name]
    ok = ate <= bound
    flag = "" if ok else "  *** ATE-BOUND-VIOLATED ***"
    print(f"{name}: {kf_per_sec:.1f} KF/s  ATE={ate:.4f} m "
          f"(bound {bound}){flag}  {extra}", file=sys.stderr, flush=True)
    return _record({"config": name, "kf_per_sec": round(kf_per_sec, 2),
                    "ate_rmse": round(ate, 5), "ate_bound": bound,
                    "ate_ok": ok, "extra": extra})


def _drive(eng, ds):
    from srba_tpu import Observation
    t0 = time.perf_counter()
    for k, frame in enumerate(ds.frames):
        obs = [Observation(lm_id=m, z=z) for m, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        eng.define_new_keyframe(obs, edge_init=edge_init)
    # Final fence: the device-master path is fully async (nothing downloaded
    # per keyframe); fence() drains the queue without downloading the
    # masters (eval/export sync later, lazily).
    eng.fence()
    return time.perf_counter() - t0


def _ate_of(eng, world, d):
    from srba_tpu.utils.datasets import ate_rmse
    G, _ = eng.create_complete_spanning_tree(0)
    n = min(len(G), len(world.gt_poses))
    return float(ate_rmse(np.asarray(G)[:n, :d], world.gt_poses[:n, :d]))


# ---------------------------------------------------------------------------
# Config 1 — 2D range-bearing SE(2), ~100-KF loop (PRIMARY metric)
# ---------------------------------------------------------------------------

def config1_setup(K=100):
    """(world, dataset, engine factory) of config#1."""
    from srba_tpu import SrbaEngine, SrbaParams
    from srba_tpu.models.noise import NoiseIdentity
    from srba_tpu.utils.datasets import make_world_loop_2d, observe

    world = make_world_loop_2d(num_kfs=K, radius=10.0, num_landmarks=180,
                               seed=11)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.01, seed=11)

    def make_engine():
        return SrbaEngine(
            "RangeBearing2D", noise=NoiseIdentity(0.005),
            params=SrbaParams(max_tree_depth=4, max_optimize_depth=4))
    return world, ds, make_engine


def bench_config1(K=100):
    world, ds, make_engine = config1_setup(K)

    def run():
        eng = make_engine()
        return eng, _drive(eng, ds)

    _, warm = run()
    print(f"config1 warmup pass: {warm:.2f}s", file=sys.stderr, flush=True)
    eng, dt = run()
    ate = _ate_of(eng, world, 2)
    _report("config1_rb2d", K / dt, ate, f"warmup={warm:.1f}s")
    return K / dt, ate


# ---------------------------------------------------------------------------
# Config 2 — 3D range-bearing SE(3)
# ---------------------------------------------------------------------------

def bench_config2(K=100):
    from srba_tpu import SrbaEngine, SrbaParams
    from srba_tpu.models.noise import NoiseIdentity
    from srba_tpu.utils.datasets import make_world_loop_3d, observe

    world = make_world_loop_3d(num_kfs=K, radius=9.0, num_landmarks=250,
                               height_amp=1.0, seed=3)
    ds = observe(world, "RangeBearing3D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.01, seed=3)

    def run():
        eng = SrbaEngine(
            "RangeBearing3D", noise=NoiseIdentity(0.005),
            params=SrbaParams(max_tree_depth=4, max_optimize_depth=4))
        return eng, _drive(eng, ds)

    run()
    eng, dt = run()
    _report("config2_rb3d", K / dt, _ate_of(eng, world, 3))


# ---------------------------------------------------------------------------
# Config 3 — stereo SE(3), Schur over landmarks, SE(3) sensor mount
# ---------------------------------------------------------------------------

def config3_setup(K=500):
    """(world, dataset, engine factory) of config#3.  Mid-size indoor
    stereo: 500 KFs is long enough that pure chain topology drifts visibly
    (ATE 2.7 m); the realistic workflow is local-areas ECP with
    landmark-vote loop closures (Umeyama-bootstrapped) plus a final global
    PGO — the reference's export-to-global-optimizer story, in-framework."""
    from srba_tpu import SrbaEngine, SrbaParams
    from srba_tpu.ecps import LocalAreasFixedGrid
    from srba_tpu.models.noise import NoiseIdentity
    from srba_tpu.models.observations import StereoCalib
    from srba_tpu.models.sensor_pose import SensorPoseSE3
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu.utils.datasets import make_world_loop_3d, observe

    world = make_world_loop_3d(num_kfs=K, radius=8.0, num_landmarks=400,
                               height_amp=0.5, seed=1)
    calib = StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                             baseline=0.12)
    ds = observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                 sensor_range=9.0, odo_noise_std=0.01, seed=1)

    def make_engine(mesh=None):
        return SrbaEngine(
            "StereoCamera", calib=calib, noise=NoiseIdentity(0.3),
            sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
            ecp=LocalAreasFixedGrid(submap_size=10,
                                    min_obs_count_loop_closure=5),
            params=SrbaParams(max_tree_depth=4, max_optimize_depth=3,
                              extra_obs_per_lm_cap=6,
                              incremental_max_iters=3),
            mesh=mesh)
    return world, ds, make_engine


def bench_config3(K=500):
    from srba_tpu.utils.datasets import ate_rmse

    world, ds, make_engine = config3_setup(K)

    def run():
        eng = make_engine()
        return eng, _drive(eng, ds)

    _, warm = run()
    eng, dt = run()
    G, _ = eng.optimize_global()
    ate = float(ate_rmse(np.asarray(G)[:, :3], world.gt_poses[:, :3]))
    return _report("config3_stereo", K / dt, ate,
                   f"{K} KFs, final global PGO, warmup={warm:.1f}s")


# ---------------------------------------------------------------------------
# Config 4 — relative-pose graph-SLAM (no landmarks, loop closures)
# ---------------------------------------------------------------------------

def bench_config4(K=150):
    from srba_tpu import SrbaEngine, SrbaParams
    from srba_tpu.models.noise import NoiseIdentity
    from srba_tpu.utils.datasets import (make_graph_slam_dataset,
                                         make_world_loop_2d)

    world = make_world_loop_2d(num_kfs=K, radius=8.0, num_landmarks=1,
                               seed=5, revolutions=2.0)
    ds = make_graph_slam_dataset(world, noise_std=0.002,
                                 loop_closure_range=1.5,
                                 odo_noise_std=0.01, seed=5)

    def run():
        eng = SrbaEngine(
            "RelativePoses2D", noise=NoiseIdentity(0.002),
            params=SrbaParams(max_tree_depth=4, max_optimize_depth=4))
        return eng, _drive(eng, ds)

    run()
    eng, dt = run()
    _report("config4_graphslam", K / dt, _ate_of(eng, world, 2),
            f"{eng.state.num_edges} edges")


# ---------------------------------------------------------------------------
# Config 5 — 5k-KF monocular, local-areas ECP + closures, sweeps + global PGO
# ---------------------------------------------------------------------------

def config5_setup(K=5000):
    """(world, dataset, engine factory) of config#5."""
    from srba_tpu import SrbaEngine, SrbaParams
    from srba_tpu.ecps import LocalAreasFixedGrid
    from srba_tpu.models.noise import NoiseIdentity
    from srba_tpu.models.observations import CameraCalib
    from srba_tpu.models.sensor_pose import SensorPoseSE3
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu.utils.datasets import (make_world_loop_3d_large,
                                         observe_sparse)

    world = make_world_loop_3d_large(num_kfs=K, radius=30.0,
                                     num_landmarks=1200, revolutions=2.5,
                                     seed=7)
    calib = CameraCalib.make()
    ds = observe_sparse(world, "MonocularCamera", calib=calib, noise_std=0.3,
                        sensor_range=7.0, odo_noise_std=0.005, seed=7)

    def make_engine():
        return SrbaEngine(
            "MonocularCamera", calib=calib, noise=NoiseIdentity(0.3),
            sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
            ecp=LocalAreasFixedGrid(submap_size=10,
                                    min_obs_count_loop_closure=6),
            params=SrbaParams(max_tree_depth=3, max_optimize_depth=2,
                              use_robust_kernel=True, kernel_param=3.0,
                              extra_obs_per_lm_cap=4,
                              # ATE frontier over the cap: 10 -> 0.870,
                              # 6 -> 0.953, 8 -> 1.053 (cap-NON-monotone
                              # near the bound: the cap shifts which closure
                              # fits run on which mirror states).  6 is the
                              # cheapest cap found inside the 1.0 bound.
                              # Throughput per cap on the GPU: not measured
                              # (ROADMAP D5).
                              incremental_max_iters=6))
    return world, ds, make_engine


def drive_config5(eng, ds):
    """The config#5 incremental loop with its periodic global PGOs.
    Returns (loop seconds through ``fence()``, seconds spent in the
    periodic PGOs)."""
    from srba_tpu import Observation

    # NO ground-truth access anywhere: landmark inits come from the
    # engine's own deferred two-view triangulation front-end
    # (engine/triangulate.py).
    t_pgo = 0.0
    t0 = time.perf_counter()
    for k, frame in enumerate(ds.frames):
        obs = [Observation(lm_id=m, z=z) for m, z in frame]
        eng.define_new_keyframe(
            obs, edge_init={k - 1: ds.odometry[k - 1]} if k else None)
        if k and k % 1250 == 0:
            # Periodic global refinement, chordal included: skipping the
            # chordal initializer on these warm-started calls cost 0.87 ->
            # 1.13 final ATE on a 5k CPU run — the periodic orientation fix
            # keeps later closure fits strong.
            # periodic=True: diminishing-returns certification + warm
            # lambda (under the terminal tolerance these refinements burned
            # 60+ iterations uncertified).
            # use_edge_info=True: monocular closure fits are depth/scale
            # DEGENERATE — anisotropic information keeps their unmeasured
            # directions from dragging the graph (ATE 0.953 shaped vs 1.022
            # scalar at cap 6).  Stereo (config#3) showed the OPPOSITE
            # (0.235 vs 0.193) and stays scalar — per-problem choice,
            # engine default off (io/export.py design note).
            t1 = time.perf_counter()
            eng.optimize_global(periodic=True, use_edge_info=True)
            t_pgo += time.perf_counter() - t1
    eng.fence()
    return time.perf_counter() - t0, t_pgo


def bench_config5(K=5000):
    from srba_tpu.utils.datasets import ate_rmse

    world, ds, make_engine = config5_setup(K)
    eng = make_engine()
    dt_inc, _ = drive_config5(eng, ds)

    # Terminal recovery is the global PGO ALONE — on a 1000-KF repro:
    # PGO-only ATE 0.27 (converged, idempotent) vs 1.1-2.2 when a
    # refine_map sweep runs before/after it.  Mono sweep windows carry a
    # local scale gauge that block-coordinate refinement exploits (pixel
    # error drops, global consistency doesn't), so map-parallel sweeps
    # stay out of the monocular pipeline.
    t0 = time.perf_counter()
    G, info = eng.optimize_global(use_edge_info=True)
    dt_ref = time.perf_counter() - t0
    ate = float(ate_rmse(G[:, :3], world.gt_poses[:, :3]))
    _report("config5_mono5k", K / dt_inc, ate,
            f"incremental {dt_inc:.1f}s + PGO {dt_ref:.1f}s, "
            f"{eng.state.num_edges} edges, {eng.num_landmarks} lms, "
            f"PGO err {info['err_init']:.2e}->{info['err_final']:.2e} "
            f"conv={info.get('converged', 0):.0f}")


# ---------------------------------------------------------------------------
# Secondary: global PGO at scale
# ---------------------------------------------------------------------------

def pgo_problem(K=20000):
    """SE(3) circle of ``K`` nodes: noisy odometry chain plus exact
    cross-circle closures every 100 nodes; nodes start 0.3/dim off truth."""
    from srba_tpu.ops.np_lie import NpSE3

    rng = np.random.default_rng(0)
    th = 2 * np.pi * np.arange(K) / K
    gt = np.stack([NpSE3.pexp(np.asarray(
        [30 * np.cos(t), 30 * np.sin(t), np.sin(3 * t), 0, 0,
         t + np.pi / 2], np.float32)) for t in th])

    def rel(i, j):
        return NpSE3.compose(NpSE3.inverse(gt[i]), gt[j]).astype(np.float32)

    edges = [{"from": k - 1, "to": k,
              "rel_pose": NpSE3.retract(
                  rel(k - 1, k), rng.normal(0, 0.02, 6).astype(np.float32))}
             for k in range(1, K)]
    for c in range(K // 100):
        i = int(c * 100)
        j = (i + K // 2) % K
        edges.append({"from": i, "to": j, "rel_pose": rel(i, j)})
    nodes = np.stack([NpSE3.retract(gt[k],
                                    rng.normal(0, 0.3, 6).astype(np.float32))
                      for k in range(K)])
    nodes[0] = gt[0]
    return {"group": "SE3", "nodes": nodes, "edges": edges}


def bench_pgo(K=20000):
    from srba_tpu.solver.global_graphslam import (PGOConfig,
                                                  optimize_global_pose_graph)

    prob = pgo_problem(K)
    # abs_tol: this synthetic's odometry noise (0.02/dim) floors the robust
    # cost at ~1.3e-5/edge — certification must sit above the noise floor.
    cfg = PGOConfig(group="SE3", max_outer=30, cg_iters=100,
                    abs_tol_per_edge=2e-5)
    optimize_global_pose_graph(prob, cfg)      # warmup/compile
    t0 = time.perf_counter()
    G, info = optimize_global_pose_graph(prob, cfg)
    dt = time.perf_counter() - t0
    print(f"secondary global PGO: {K} nodes / {len(prob['edges'])} edges SE3 "
          f"in {dt:.2f}s  err {info['err_init']:.2e}->"
          f"{info['err_final']:.2e} converged={info['converged']:.0f} "
          f"iters={info['iters']:.0f}", file=sys.stderr, flush=True)
    return _record({"config": f"pgo{K // 1000}k", "seconds": round(dt, 2),
                    "err_final": float(info["err_final"]),
                    "converged": float(info["converged"]),
                    "iters": float(info["iters"])})


def main() -> int:
    from srba_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    kf_per_sec, ate1 = bench_config1()

    # Primary metric FIRST (one JSON line on stdout; the other configs
    # report to stderr + BENCH_DETAIL.json and must not corrupt it).
    ok1 = ate1 <= ATE_BOUNDS["config1_rb2d"]
    print(json.dumps({
        "metric": "keyframes/sec (LM+Schur, config#1 2D range-bearing "
                  f"100-KF loop, ATE={ate1:.4f})",
        "value": round(kf_per_sec, 2),
        "unit": "keyframes/sec",
        "vs_baseline": round(kf_per_sec / REF_KF_PER_SEC if ok1 else 0.0, 3),
        "device": {k: DETAIL[0][k] for k in ("platform", "device_kind",
                                              "count", "nvidia_smi")},
    }), flush=True)

    failed = []
    for fn in (bench_config2, bench_config3, bench_config4, bench_config5,
               bench_pgo):
        # One config raising must not hide the others' results; it still
        # fails the run (exit code) once the detail file is written.
        try:
            fn()
        except Exception as ex:
            print(f"{fn.__name__} failed: {ex!r}", file=sys.stderr,
                  flush=True)
            _record({"config": fn.__name__, "error": repr(ex)})
            failed.append(fn.__name__)
    failed += [d["config"] for d in DETAIL if d.get("ate_ok") is False]
    with open("BENCH_DETAIL.json", "w") as f:
        json.dump(DETAIL, f, indent=1)
    if failed:
        print(f"bench FAILED: {failed}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
