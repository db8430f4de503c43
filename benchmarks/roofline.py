"""Roofline measurement of the hot device programs on an NVIDIA GPU.

For each program: XLA's own cost model (``compiled.cost_analysis()``:
flops + bytes accessed) and the measured time on the card give achieved
FLOP/s and bytes/s, arithmetic intensity, and the roofline bound against
the card's peaks from :data:`PEAKS`, looked up by JAX's ``device_kind``.
An unknown kind is an error: no peak is ever assumed.

The solvers pin ``jax.default_matmul_precision("highest")``, so their
float32 products run on the FP32 units, not the tensor cores: achieved
FLOP/s is divided by the FP32 peak.  ``--trace DIR`` captures a profiler
trace of the config#3-bucket window solve and prints the device kernels by
time, so the GEMM kernel names can confirm which units ran.

Programs measured:
1. window LM+Schur solve at the per-keyframe bucket shapes the bench
   configs run (small — dispatch/latency dominated by design);
2. the same program at a LARGE window;
3. batched SPD inverse (ops/block_linalg.py) at PGO scale;
4. global PGO (LM+PCG) end-to-end at 20k SE(3) nodes.

Run: python benchmarks/roofline.py [--trace DIR]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

# Dense (no sparsity) peaks per card, keyed by ``jax.Device.device_kind``
# (NVIDIA H100 data sheet; the rates assume the card's full power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {          # H100 SXM5, 700 W
        "fp32_flops": 67e12, "hbm_bps": 3.35e12},
    "NVIDIA H100 PCIe": {               # H100 PCIe, 350 W
        "fp32_flops": 51e12, "hbm_bps": 2.0e12},
}


def peaks_for(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; raises ``KeyError`` when unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates recorded for device kind "
                       f"{device_kind!r} (known: {sorted(PEAKS)})") from None


def _fmt(x, unit=""):
    for s, f in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(x) >= f:
            return f"{x/f:.2f} {s}{unit}"
    return f"{x:.2f} {unit}"


def measure(name, jitted, args, peaks, reps=5):
    """Compile, cost-analyze, and time one program (median of ``reps``,
    each ended by ``block_until_ready``)."""
    import jax
    compiled = jitted.lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    bytes_ = float(ca.get("bytes accessed", 0.0))
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    pf, pb = peaks["fp32_flops"], peaks["hbm_bps"]
    ai = flops / bytes_ if bytes_ else float("nan")
    achieved_f = flops / dt if dt else 0.0
    achieved_b = bytes_ / dt if dt else 0.0
    bound = "compute" if ai > pf / pb else "memory"
    floor = max(flops / pf, bytes_ / pb)
    print(f"{name}")
    print(f"  flops={_fmt(flops, 'F')}  bytes={_fmt(bytes_, 'B')}  "
          f"AI={ai:.1f} F/B ({bound}-bound at the FP32 peak)")
    print(f"  time={dt*1e3:.3f} ms (median of {reps}); roofline share "
          f"{floor / dt * 100 if dt else 0.0:.2f}%")
    print(f"  achieved {_fmt(achieved_f, 'FLOP/s')} "
          f"({achieved_f/pf*100:.2f}% of FP32 peak); {_fmt(achieved_b, 'B/s')}"
          f" ({achieved_b/pb*100:.2f}% of memory peak)")
    return {"name": name, "flops": flops, "bytes": bytes_, "ms": dt * 1e3,
            "achieved_flops": achieved_f, "achieved_bps": achieved_b}


def window_solver(E, L, N, iters=6, neq="onehot"):
    import jax
    from benchmarks.solver_engines import make_batch
    from srba_tpu.solver.lm import SolverConfig, make_solver_impl
    batch = make_batch(E, L, N)
    cfg = SolverConfig(obs_model="RangeBearing3D", pose_group="SE3",
                       lm_type="Euclidean3D", max_depth=4,
                       solver="schur_dense_cholesky", max_iters=iters,
                       rel_tol=0.0, neq=neq)
    solve, _ = make_solver_impl(cfg)
    return jax.jit(solve), (batch,)


def spd_inverse_prog(B=20480, d=6):
    import jax
    import jax.numpy as jnp
    from srba_tpu.ops.block_linalg import spd_inverse
    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (B, d, d)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", A, A) + 3 * np.eye(d, dtype=np.float32)
    return jax.jit(spd_inverse), (jnp.asarray(H),)


def pgo_20k():
    """End-to-end PGO wall time (bench.py's 20k-node problem)."""
    import bench
    from srba_tpu.solver.global_graphslam import (PGOConfig,
                                                  optimize_global_pose_graph)
    prob = bench.pgo_problem(20000)
    cfg = PGOConfig(group="SE3", max_outer=30, cg_iters=100,
                    abs_tol_per_edge=2e-5)
    optimize_global_pose_graph(prob, cfg)
    t0 = time.perf_counter()
    G, info = optimize_global_pose_graph(prob, cfg)
    dt = time.perf_counter() - t0
    print(f"global PGO 20k SE(3) nodes / {len(prob['edges'])} edges: "
          f"{dt:.3f} s hot ({info.get('iters', 0):.0f} outer iters, "
          f"err {info['err_init']:.2e} -> {info['err_final']:.2e})")


def device_kernel_times(trace_dir: str, plane_prefix: str = "/device:GPU"):
    """{kernel name: total device ns} over the planes of the newest
    ``.xplane.pb`` under ``trace_dir`` whose name starts with
    ``plane_prefix``."""
    from jax.profiler import ProfileData

    files = sorted(pathlib.Path(trace_dir).rglob("*.xplane.pb"),
                   key=lambda p: p.stat().st_mtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    totals: dict = {}
    for plane in ProfileData.from_file(str(files[-1])).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[ev.name] = totals.get(ev.name, 0) + ev.duration_ns
    return totals


def trace_window(trace_dir: str, bucket=(16, 256, 2048), top=25):
    """Trace a few config#3-bucket window solves; print device kernels by
    time (GEMM names tell FP32 units from tensor cores)."""
    import jax
    jitted, args = window_solver(*bucket)
    jax.block_until_ready(jitted(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            jax.block_until_ready(jitted(*args))
    totals = device_kernel_times(trace_dir)
    print(f"device kernels of 3 window solves E,L,N={bucket} "
          f"(total {sum(totals.values()) / 1e6:.3f} ms):")
    for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ns / 1e3:10.1f} us  {name[:140]}")
    return totals


def main(argv=None):
    import jax
    parser = argparse.ArgumentParser(description="roofline of hot programs")
    parser.add_argument("--trace", metavar="DIR",
                        help="also trace the config#3-bucket window solve")
    args = parser.parse_args(argv)
    from srba_tpu.utils.compile_cache import enable_compile_cache
    from srba_tpu.utils.devices import nvidia_smi_name_power
    enable_compile_cache()
    kind = jax.devices()[0].device_kind
    peaks = peaks_for(kind)
    print(f"device: {kind} ({nvidia_smi_name_power()}); peaks {peaks}")
    for name, (E, L, N), neq in (
            ("LM+Schur @ config#1 bucket (E=8, L=64, N=512, 6 iters)",
             (8, 64, 512), "onehot"),
            ("LM+Schur @ config#3 bucket (E=16, L=256, N=2048, 6 iters)",
             (16, 256, 2048), "onehot"),
            ("LM+Schur @ config#3 bucket, segmented neq",
             (16, 256, 2048), "segmented"),
            ("LM+Schur @ large window (E=256, L=4096, N=16384, 6 iters), "
             "onehot neq",
             (256, 4096, 16384), "onehot"),
            ("LM+Schur @ large window, segmented neq",
             (256, 4096, 16384), "segmented"),
    ):
        jitted, fargs = window_solver(E, L, N, neq=neq)
        measure(name, jitted, fargs, peaks)
    jitted, fargs = spd_inverse_prog()
    measure("batched SPD inverse [20480, 6, 6]", jitted, fargs, peaks)
    pgo_20k()
    if args.trace:
        trace_window(args.trace)


if __name__ == "__main__":
    main()
