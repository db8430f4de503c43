"""Solver-engine decision benchmark: dense-Schur vs no-Schur at a LARGE
window (E>=256 edges, L>=4096 landmarks) — the measurement backing the
decision to drop the reference's sparse-Cholesky solver variants
(``solver_LM_schur_sparse_cholesky`` / ``solver_LM_no_schur_sparse_cholesky``
options, public MRPT/srba layout; see ``srba_tpu/solver/lm.py`` SolverConfig
docstring and docs/MATH.md §5).

Builds a synthetic-but-consistent RangeBearing3D window batch directly (no
engine), runs both solver engines for a FIXED iteration budget, and reports
wall time per LM iteration on the default device:

    python benchmarks/solver_engines.py [E] [L] [N]
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from srba_tpu.models.observations import RangeBearing3D
from srba_tpu.ops.np_lie import NpSE3, compose_path
from srba_tpu.solver.lm import SolverConfig, WindowBatch, make_lm_solver


def make_batch(E: int, L: int, N: int, D: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    # Chain of E edges with small relative motions (an E-KF trajectory).
    edge_pose = np.stack([
        NpSE3.pexp(rng.normal(0, 0.15, 6).astype(np.float32))
        for _ in range(E)])
    # Global pose at KF k = compose of edges 0..k-1 (edge e: T_{e+1<-e}).
    G = [NpSE3.identity()]
    for e in range(E):
        G.append(NpSE3.compose(G[-1], NpSE3.inverse(edge_pose[e])))
    lm_world = rng.uniform(-5, 5, (L, 3)).astype(np.float32)
    lm_base_kf = rng.integers(0, E + 1, L)
    lm_state = np.stack([
        NpSE3.apply(NpSE3.inverse(G[lm_base_kf[l]]), lm_world[l])
        for l in range(L)]).astype(np.float32)

    obs_lm = rng.integers(0, L, N).astype(np.int32)
    path_edge = np.zeros((N, D), np.int32)
    path_sign = np.zeros((N, D), np.float32)
    obs_z = np.zeros((N, 3), np.float32)
    for i in range(N):
        base = int(lm_base_kf[obs_lm[i]])
        # Observer within D hops of the base along the chain.
        obs_kf = max(0, base - int(rng.integers(0, D + 1)))
        hops = base - obs_kf
        # Path obs_kf -> base along the chain: edges obs_kf..base-1, each
        # traversed REVERSE (edge e maps frame e -> e+1... our convention:
        # T stored is T_{e+1<-e}; composing toward base needs inverses).
        path = [(obs_kf + k, -1) for k in range(hops)]
        for k, (e, s) in enumerate(path):
            path_edge[i, k] = e
            path_sign[i, k] = s
        T = compose_path(NpSE3, edge_pose, path) if path \
            else NpSE3.identity()
        pt = NpSE3.apply(T, lm_state[obs_lm[i]])
        obs_z[i] = np.asarray(RangeBearing3D.h(pt.astype(np.float32)))
    obs_z += rng.normal(0, 0.01, obs_z.shape).astype(np.float32)

    # Perturb the unknowns so LM has real work.
    edge_pose = np.stack([
        NpSE3.retract(edge_pose[e], rng.normal(0, 0.02, 6))
        for e in range(E)]).astype(np.float32)
    lm_state = (lm_state + rng.normal(0, 0.05, lm_state.shape)
                ).astype(np.float32)

    import jax.numpy as jnp
    return WindowBatch(
        edge_pose=jnp.asarray(edge_pose),
        edge_opt=jnp.ones(E, jnp.float32),
        lm_state=jnp.asarray(lm_state),
        lm_opt=jnp.ones(L, jnp.float32),
        obs_z=jnp.asarray(obs_z),
        obs_lm=jnp.asarray(obs_lm),
        path_edge=jnp.asarray(path_edge),
        path_sign=jnp.asarray(path_sign),
        obs_valid=jnp.ones(N, jnp.float32),
        whitener=jnp.eye(3, dtype=jnp.float32) * 100.0,
        sensor_pose_inv=jnp.asarray(NpSE3.identity()),
        calib=None,
    )


def time_solver(solver: str, batch, iters: int = 6) -> float:
    import jax
    cfg = SolverConfig(
        obs_model="RangeBearing3D", pose_group="SE3", lm_type="Euclidean3D",
        max_depth=4, solver=solver, max_iters=iters, rel_tol=0.0)
    solve, _ = make_lm_solver(cfg)
    jax.block_until_ready(solve(batch))  # compile + warmup
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = solve(batch)
        info = {k: float(v) for k, v in jax.device_get(out[2]).items()}
    dt = (time.perf_counter() - t0) / reps
    return dt, info


def main():
    E = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    N = int(sys.argv[3]) if len(sys.argv) > 3 else 16384
    print(f"window: E={E} edges (SE3), L={L} landmarks, N={N} obs, depth 4")
    batch = make_batch(E, L, N)
    for solver in ("schur_dense_cholesky", "no_schur_dense_cholesky"):
        try:
            dt, info = time_solver(solver, batch)
            print(f"{solver:28s}: {dt*1e3:8.1f} ms / solve "
                  f"({dt/info['iters']*1e3:6.1f} ms/iter, "
                  f"iters={info['iters']:.0f}, "
                  f"err {info['err_init']:.3e} -> {info['err_final']:.3e})")
        except Exception as ex:
            print(f"{solver:28s}: FAILED {ex!r}")


if __name__ == "__main__":
    main()
