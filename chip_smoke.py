"""Smoke test of the SRBA engine on an NVIDIA GPU, through the entry points
a user calls, at the bench configurations' full sizes.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the mesh paths, nothing else

Phases (one process; the CPU backend serves the reference comparisons):

1. window LM+Schur solve on the GPU against the same solve on the CPU;
2. config#3 of ``bench.py`` end to end (500 stereo keyframes, local-areas
   ECP with closures, final ``optimize_global``) against its ATE bound;
3. the 20k-node SE(3) global PGO of ``bench.py``: converged, error bound;
4. the CLI in process, then ``refine_map`` on a config#1 engine;
5. batched SPD inverse against a float64 numpy inverse, and its time
   beside ``jnp.linalg.inv``.

Every phase raises on failure, so the process exits non-zero and prints no
result line.  It also exits non-zero when JAX finds no GPU or the native
graph core does not load.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time

import numpy as np

# Window solves, GPU vs CPU.  The two sum in different orders, so they
# part by a few float32 ulps.  Read on an H100 with the precision pin (three
# runs): states <= 5.7e-6 apart, config#3-bucket err_final <= 3.6e-7
# relative.  With the pin forced to TF32 the config#3 bucket reads 3.1e-5
# (states) and 2.6e-6 (err), and XLA's default precision 3.4e-5 and
# 7.1e-6; the bounds sit between.  The noise-free stereo window ends at
# err ~6e-9 on both sides, a float32 floor that ERR_ATOL covers; it cannot
# tell TF32 from the pin.
STATE_ATOL = 1.5e-5
ERR_RTOL = 1e-6
ERR_ATOL = 1e-8
# 20k-node PGO: 6 * 20199 measurements - 6 * 19999 unknowns = 1200 residual
# degrees of freedom at odometry sigma 0.02 -> chi^2 expectation
# 1200 * 0.02^2 = 0.48; twice that bounds a converged solve.
PGO_ERR_BOUND = 1.0
# Four cards vs one.  The sharded programs sum in another order and the
# sweep pads its window batch to a multiple of the mesh, so LM's
# accept/reject steps can differ: refine_map's states read 6.1e-5 apart
# (edges, config#1; its observation noise is 5e-3), optimize_global's ATE
# 1.3e-4 m apart.
MESH_STATE_ATOL = 3e-4
MESH_ATE_TOL = 1e-3
# SPD inverse: blocks A A^T + d I have condition <= ~7, so float32 loses
# ~d * kappa * eps_f32 ~ 5e-6 relative; 1e-5 relative to the block's
# largest entry.
SPD_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, *what) -> None:
    """A phase check that also holds under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def _max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _check_solve_match(name, out, ref):
    """``out``/``ref``: (edge_pose, lm_state, info) of the same window."""
    import jax

    (e1, l1, i1), (e0, l0, i0) = jax.device_get(out), jax.device_get(ref)
    de, dl = _max_abs_diff(e1, e0), _max_abs_diff(l1, l0)
    err1, err0 = float(i1["err_final"]), float(i0["err_final"])
    derr = abs(err1 - err0)
    tol = ERR_RTOL * abs(err0) + ERR_ATOL
    log(f"  {name}: err_final {err1:.6e} vs ref {err0:.6e} (|d|={derr:.2e}, "
        f"tol {tol:.2e}); iters {int(i1['iters'])} vs {int(i0['iters'])}; "
        f"max|d edge|={de:.2e} max|d lm|={dl:.2e} (tol {STATE_ATOL})")
    require(np.isfinite(err1) and np.all(np.isfinite(np.asarray(e1))), name)
    require(derr <= tol, (name, err1, err0))
    require(de <= STATE_ATOL and dl <= STATE_ATOL, (name, de, dl))


@contextlib.contextmanager
def _fresh_compiles():
    """Compile inside without the persistent cache.  A cache shared between
    hosts may hold CPU executables built for another CPU; the reference
    must be this host's own compile."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    was_on = jax.config.jax_enable_compilation_cache
    cc.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was_on)
        cc.reset_cache()


def _rb3d_window(bucket):
    """(SolverConfig, batch) of a synthetic RangeBearing3D window at bucket
    (E, L, N) with the engine's default LM settings."""
    from benchmarks.solver_engines import make_batch
    from srba_tpu.solver.lm import SolverConfig

    cfg = SolverConfig(obs_model="RangeBearing3D", pose_group="SE3",
                       lm_type="Euclidean3D", max_depth=4)
    return cfg, make_batch(*bucket)


def phase_window(bucket=(16, 256, 2048)):
    """1. One LM+Schur window solve on the default device vs the CPU."""
    import jax

    import __graft_entry__
    from srba_tpu.solver.lm import make_solver_impl

    stereo_solve, (stereo_batch,) = __graft_entry__.entry()
    cfg, rb3d_batch = _rb3d_window(bucket)
    E, L, N = bucket
    cpu = jax.devices("cpu")[0]
    for name, solve, batch in (
            ("stereo window (entry)", stereo_solve, stereo_batch),
            (f"RB3D window E={E} L={L} N={N}", make_solver_impl(cfg)[0],
             rb3d_batch)):
        fn = jax.jit(solve)
        out = jax.block_until_ready(fn(batch))
        with _fresh_compiles():
            ref = jax.block_until_ready(fn(jax.device_put(batch, cpu)))
        _check_solve_match(name, out, ref)


def phase_engine(K=500):
    """2. bench config#3 end to end: ATE within the bench bound."""
    import bench

    rec = bench.bench_config3(K)
    log(f"  config#3 {K} KF: {rec['kf_per_sec']} KF/s on "
        f"{rec['device_kind']} ({rec['nvidia_smi']}); ATE {rec['ate_rmse']} "
        f"(bound {rec['ate_bound']}); {rec['extra']}")
    require(rec["ate_ok"], rec)
    return rec


def phase_pgo(K=20000):
    """3. bench's SE(3) global PGO: certified convergence, error bound."""
    import bench

    rec = bench.bench_pgo(K)
    log(f"  PGO {K} nodes: {rec['seconds']} s, err_final "
        f"{rec['err_final']:.4e} (bound {PGO_ERR_BOUND}), converged "
        f"{rec['converged']:.0f}, iters {rec['iters']:.0f}")
    require(rec["converged"] == 1.0, rec)
    require(rec["err_final"] <= PGO_ERR_BOUND, rec)
    return rec


def phase_cli(num_kfs=100, refine_kfs=100):
    """4. ``srba_slam`` in process, then ``refine_map(sweeps=2)`` on a
    config#1 engine.  The CLI's ``loop2d`` defaults are config#1's world,
    so both runs are held to config#1's ATE bound from bench.py."""
    import bench
    from srba_tpu import cli

    ate_bound = bench.ATE_BOUNDS["config1_rb2d"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--synthetic", "loop2d", "--num-kfs", str(num_kfs),
                       "--global-opt", "--json"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  cli rc={rc}: {summary}")
    require(rc == 0 and summary["num_kfs"] == num_kfs, summary)
    require(summary["ate_rmse"] <= ate_bound, summary)

    world, ds, make_engine = bench.config1_setup(refine_kfs)
    eng = make_engine()
    bench._drive(eng, ds)
    e0 = eng.eval_overall_squared_error()
    info = eng.refine_map(sweeps=2)
    e1 = eng.eval_overall_squared_error()
    ate = bench._ate_of(eng, world, 2)
    log(f"  refine_map(sweeps=2) on config#1 {refine_kfs} KF: "
        f"{info['windows']:.0f} windows, map err {e0:.4e} -> {e1:.4e}, "
        f"ATE {ate:.4f} (bound {ate_bound})")
    require(np.isfinite(e1) and ate <= ate_bound, (e0, e1, ate))


def _time_ms(fn, x, reps=20):
    import jax

    jax.block_until_ready(fn(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_spd_inverse(shapes=((20480, 6), (131072, 6), (4096, 3))):
    """5. ``spd_inverse`` vs float64 numpy; unrolled vs ``linalg.inv``."""
    import jax
    import jax.numpy as jnp

    from srba_tpu.ops.block_linalg import spd_inverse, spd_inverse_unrolled

    rng = np.random.default_rng(0)
    timings = []
    for B, d in shapes:
        A = rng.normal(size=(B, d, d)).astype(np.float32)
        H = A @ A.transpose(0, 2, 1) + d * np.eye(d, dtype=np.float32)
        ref = np.linalg.inv(H.astype(np.float64))
        x = jnp.asarray(H)
        got = np.asarray(jax.device_get(jax.jit(spd_inverse)(x)), np.float64)
        rel = float(np.max(np.max(np.abs(got - ref), axis=(1, 2))
                           / np.max(np.abs(ref), axis=(1, 2))))
        t_unrolled = _time_ms(jax.jit(spd_inverse_unrolled), x)
        t_inv = _time_ms(jax.jit(jnp.linalg.inv), x)
        log(f"  spd_inverse [{B},{d},{d}]: max rel err vs float64 "
            f"{rel:.2e} (tol {SPD_RTOL}); unrolled {t_unrolled:.4f} ms, "
            f"jnp.linalg.inv {t_inv:.4f} ms (median of 20)")
        require(rel <= SPD_RTOL, (B, d, rel))
        timings.append({"shape": [B, d, d], "unrolled_ms": t_unrolled,
                        "linalg_inv_ms": t_inv, "max_rel_err": rel})
    return timings


# ---------------------------------------------------------------------------
# Four cards: the mesh paths a user reaches through the public API.
# ---------------------------------------------------------------------------

def _gpus_that_ran(thunk):
    """Run ``thunk`` under the profiler; return its result and the ids of
    the GPUs whose trace plane holds a kernel (copies do not count)."""
    import jax

    from benchmarks.roofline import device_kernel_times

    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            out = jax.block_until_ready(thunk())
        ran = [dev.id for dev in jax.devices()
               if any(not k.startswith(("Memcpy", "Memset"))
                      for k in device_kernel_times(d, f"/device:GPU:{dev.id}"))]
    return out, ran


def _on_gpus(name, n, thunk):
    """Result of the mesh call ``thunk``, which must run kernels on ``n``
    distinct GPUs (read from its profiler trace, not from where its inputs
    were put)."""
    out, ran = _gpus_that_ran(thunk)
    log(f"  {name}: kernels ran on {len(ran)} GPUs, ids {ran}")
    require(len(ran) == n, (name, ran, n))
    return out


def four_window(n=4, bucket=(16, 256, 2048)):
    """Obs-sharded window solve over ``make_mesh(n)`` vs one device."""
    from srba_tpu.parallel.sharding import (make_mesh, make_spmd_solver,
                                            shard_batch)
    from srba_tpu.solver.lm import make_lm_solver

    cfg, batch = _rb3d_window(bucket)
    name = "RB3D window E={} L={} N={}".format(*bucket)
    ref = make_lm_solver(cfg)[0](batch)
    mesh = make_mesh(n)
    spmd, _ = make_spmd_solver(cfg, mesh)
    out = _on_gpus(name, n, lambda: spmd(shard_batch(batch, mesh)))
    _check_solve_match(f"{name} on {n} devices", out, ref)


def four_refine_map(n=4, K=100):
    """``refine_map(mesh=make_mesh(n))`` vs ``mesh=None`` on config#1."""
    import bench
    from srba_tpu.parallel.sharding import make_mesh

    world, ds, make_engine = bench.config1_setup(K)
    engines = []
    for mesh in (None, make_mesh(n)):
        eng = make_engine()
        bench._drive(eng, ds)
        if mesh is None:
            info = eng.refine_map(sweeps=2)
        else:
            info = _on_gpus("refine_map", n,
                            lambda: eng.refine_map(sweeps=2, mesh=mesh))
        eng.sync()
        engines.append((eng, info))
    (e1, i1), (e4, i4) = engines
    ne, nl = e1.state.num_edges, e1.state.num_lms
    de = _max_abs_diff(e4.state.k2k_pose[:ne], e1.state.k2k_pose[:ne])
    dl = _max_abs_diff(e4.state.lm_state[:nl], e1.state.lm_state[:nl])
    log(f"  refine_map on {n} devices vs 1: {i4['windows']:.0f} windows, "
        f"max|d edge|={de:.2e} max|d lm|={dl:.2e} (tol {MESH_STATE_ATOL})")
    require(de <= MESH_STATE_ATOL and dl <= MESH_STATE_ATOL, (de, dl))


def four_optimize_global(n=4, K=500):
    """``optimize_global(mesh=make_mesh(n))`` vs one device on the
    config#3 graph."""
    import bench
    from srba_tpu.parallel.sharding import make_mesh
    from srba_tpu.utils.datasets import ate_rmse

    world, ds, make_engine = bench.config3_setup(K)
    eng = make_engine()
    bench._drive(eng, ds)
    G1, i1 = eng.optimize_global(write_back=False)
    mesh = make_mesh(n)
    G4, i4 = _on_gpus("optimize_global", n, lambda: eng.optimize_global(
        write_back=False, mesh=mesh))
    a1 = float(ate_rmse(G1[:, :3], world.gt_poses[:, :3]))
    a4 = float(ate_rmse(G4[:, :3], world.gt_poses[:, :3]))
    log(f"  optimize_global config#3 {K} KF on {n} devices vs 1: ATE "
        f"{a4:.5f} vs {a1:.5f} (tol {MESH_ATE_TOL}), err_final "
        f"{i4['err_final']:.5e} vs {i1['err_final']:.5e}, converged "
        f"{i4['converged']:.0f}/{i1['converged']:.0f}, max|d position|="
        f"{_max_abs_diff(G4[:, :3], G1[:, :3]):.2e}")
    bound = bench.ATE_BOUNDS["config3_stereo"]
    require(abs(a4 - a1) <= MESH_ATE_TOL and a4 <= bound, (a1, a4))


def _run(name, fn, *args):
    log(f"[{name}]")
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the mesh paths over four cards")
    args = parser.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend "
              f"{jax.default_backend()!r}); nothing run", file=sys.stderr)
        return 2
    devices = jax.devices()
    n = 4 if args.four else 1
    if len(devices) < n:
        print(f"chip_smoke: needs {n} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from srba_tpu.native import get_lib
    from srba_tpu.utils.compile_cache import enable_compile_cache
    from srba_tpu.utils.devices import nvidia_smi_name_power

    log(f"nvidia-smi: {nvidia_smi_name_power()}")
    log(f"jax {jax.__version__}; devices: {len(devices)} x "
        f"{devices[0].device_kind}")
    native = get_lib() is not None
    log(f"native graph core loaded: {native}")
    if not native:
        print("chip_smoke: the native graph core did not build/load; the "
              "timed host path would be the Python fallback",
              file=sys.stderr)
        return 3
    log(f"compile cache: {enable_compile_cache()}")

    if args.four:
        _run("four: obs-sharded window solve", four_window, n)
        _run("four: refine_map over the mesh", four_refine_map, n)
        _run("four: optimize_global over the mesh", four_optimize_global, n)
    else:
        _run("1 window solve, GPU vs CPU", phase_window)
        _run("2 engine config#3, 500 KF", phase_engine)
        _run("3 global PGO, 20k nodes", phase_pgo)
        _run("4 CLI + refine_map", phase_cli)
        _run("5 batched SPD inverse", phase_spd_inverse)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
