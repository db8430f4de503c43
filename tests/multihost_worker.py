"""Multi-process worker for tests/test_multihost.py — one OS process of a
real ``jax.distributed`` ring (gloo over localhost; SURVEY.md §3.1
"Collective backend", §8 M4).

Usage: python tests/multihost_worker.py <pid> <nprocs> <port> <mode> <out>
Modes:
  engine — coordinator feeds a synthetic RangeBearing2D sequence through
           MultiHostEngine (per-KF broadcast sync + obs-sharded global-mesh
           LM); every process reports its replica's ATE + pose checksum.
           Env SRBA_MH_BATCH sets MultiHostEngine.broadcast_batch.
  pgo    — edge-sharded global PGO over the global mesh.
Env SRBA_MH_DEVS sets the virtual CPU devices per process (default 2).
Each process writes one JSON line to <out>.<pid>.
"""

import json
import os
import sys


def main() -> int:
    pid, nprocs, port, mode, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    os.environ["JAX_PLATFORMS"] = "cpu"
    devs = int(os.environ.get("SRBA_MH_DEVS", "2"))
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devs}"

    import numpy as np

    from srba_tpu.parallel import multihost as mh
    mh.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=nprocs, process_id=pid)
    import jax
    assert jax.process_count() == nprocs
    res = {"pid": pid, "n_devices": jax.device_count()}

    if mode == "engine":
        from srba_tpu.engine.engine import Observation, SrbaParams
        from srba_tpu.utils.datasets import (ate_rmse, make_world_loop_2d,
                                             observe)
        world = make_world_loop_2d(num_kfs=12, radius=6.0, num_landmarks=40,
                                   seed=5)
        from srba_tpu.models.noise import NoiseIdentity
        batch = int(os.environ.get("SRBA_MH_BATCH", "1"))
        eng = mh.MultiHostEngine(
            "RangeBearing2D", noise=NoiseIdentity(0.005),
            broadcast_batch=batch,
            params=SrbaParams(max_tree_depth=3, max_optimize_depth=3))
        if mh.is_coordinator():
            ds = observe(world, "RangeBearing2D", noise_std=0.005,
                         sensor_range=5.0, odo_noise_std=0.01, seed=5)
            for k, frame in enumerate(ds.frames):
                eng.define_new_keyframe(
                    [Observation(lm_id=m, z=z) for m, z in frame],
                    edge_init={k - 1: ds.odometry[k - 1]} if k else None)
            eng.stop()
        else:
            served = eng.serve()
            res["served"] = served
        G, _ = eng.create_complete_spanning_tree(0)
        res["ate"] = float(ate_rmse(G[:, :2], world.gt_poses[:, :2]))
        res["gsum"] = float(np.abs(G).sum())
        res["num_kfs"] = eng.num_keyframes
    elif mode == "pgo":
        from srba_tpu.ops.np_lie import NpSE3
        from srba_tpu.solver.global_graphslam import (
            PGOConfig, optimize_global_pose_graph)
        rng = np.random.default_rng(0)
        K = 40
        th = 2 * np.pi * np.arange(K) / K
        gt = np.stack([NpSE3.pexp(np.asarray(
            [5 * np.cos(t), 5 * np.sin(t), 0, 0, 0, t], np.float32))
            for t in th])

        def rel(i, j):
            return NpSE3.compose(NpSE3.inverse(gt[i]),
                                 gt[j]).astype(np.float32)

        edges = [{"from": k - 1, "to": k, "rel_pose": NpSE3.retract(
            rel(k - 1, k), rng.normal(0, 0.01, 6).astype(np.float32))}
            for k in range(1, K)]
        edges.append({"from": 0, "to": K - 1, "rel_pose": rel(0, K - 1)})
        nodes = np.stack([NpSE3.retract(
            gt[k], rng.normal(0, 0.1, 6).astype(np.float32))
            for k in range(K)])
        nodes[0] = gt[0]
        prob = {"group": "SE3", "nodes": nodes, "edges": edges}
        G, info = optimize_global_pose_graph(
            prob, PGOConfig(group="SE3", max_outer=15, cg_iters=50),
            mesh=mh.global_mesh())
        res["err_final"] = info["err_final"]
        res["gsum"] = float(np.abs(G).sum())
    else:
        raise SystemExit(f"unknown mode {mode}")

    mh.sync_processes("done")
    with open(f"{out}.{pid}", "w") as f:
        f.write(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
