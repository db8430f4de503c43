"""Per-stage wall-clock attribution of bench config#5 (5k-KF monocular):
where do the milliseconds per keyframe go?

Drives the exact ``bench.py`` config#5 workload (``bench.config5_setup``
and ``bench.drive_config5``: same world, engine parameters and periodic
PGOs, then the terminal ``optimize_global(use_edge_info=True)``), then
prints:

* the engine profiler's mean/min/max table (alloc / ecp /
  closure_bootstrap / ingest / window_build / device_step ...);
* the device-master mirror sync stats (prefetch hits vs blocking misses);
* wall-clock shares: incremental loop vs periodic PGOs vs terminal PGO.

Run: python benchmarks/profile_config5.py [K]
"""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(K: int = 5000) -> None:
    import bench
    from srba_tpu.utils.compile_cache import enable_compile_cache
    from srba_tpu.utils.datasets import ate_rmse
    from srba_tpu.utils.devices import device_record

    enable_compile_cache()
    print(f"device: {device_record()}")
    world, ds, make_engine = bench.config5_setup(K)
    eng = make_engine()
    dt_inc, t_pgo_mid = bench.drive_config5(eng, ds)

    t0 = time.perf_counter()
    G, info = eng.optimize_global(use_edge_info=True)
    dt_term = time.perf_counter() - t0
    ate = float(ate_rmse(G[:, :3], world.gt_poses[:, :3]))

    print(eng.profiler.report())
    if eng.device_master is not None:
        print(f"\nmirror sync stats: {eng.device_master.sync_stats}")
    per_kf = (dt_inc - t_pgo_mid) / K * 1e3
    print(f"\nwall: incremental {dt_inc:.1f}s total "
          f"({dt_inc - t_pgo_mid:.1f}s loop = {per_kf:.2f} ms/KF "
          f"+ {t_pgo_mid:.1f}s periodic PGOs), terminal PGO {dt_term:.1f}s")
    print(f"KF/s (incl. periodic PGOs): {K / dt_inc:.1f}   "
          f"ATE {ate:.4f}  PGO conv={info.get('converged', 0):.0f} "
          f"iters={info.get('iters', 0):.0f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5000)
