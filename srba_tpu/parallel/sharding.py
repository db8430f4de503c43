"""SPMD execution of the LM+Schur solver over a device mesh.

The reference is single-process/single-threaded (SURVEY.md §3.1); this module
is the genuinely new axis: **observation-sharded data parallelism with a
distributed Schur reduction**.  Observations of a window are partitioned over
the mesh's ``obs`` axis; every device evaluates residuals/Jacobians for its
shard and the partial normal equations ``(H_p, g_p, H_f, g_f, H_pf)`` are
``psum``-reduced across devices (inserted inside the jitted LM loop by
``make_solver_impl`` when ``cfg.axis_name`` is set).  The reduced camera
system is solved replicated on all devices — it is tiny (window-bounded), so
replication beats a distributed Cholesky at these sizes.

Larger-scale sharding (landmark blocks via reduce_scatter, multi-host
sync of the host graph) layers on top of this entry point.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from srba_tpu.solver.lm import SolverConfig, WindowBatch, make_solver_impl

OBS_AXIS = "obs"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the observation-parallel axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (OBS_AXIS,))


def _batch_specs(batch: WindowBatch):
    """PartitionSpec pytree for a WindowBatch: observation tables sharded on
    axis 0, state/calibration replicated."""
    sharded = P(OBS_AXIS)
    repl = P()
    calib_spec = jax.tree.map(lambda _: repl, batch.calib)
    return WindowBatch(
        edge_pose=repl, edge_opt=repl,
        lm_state=repl, lm_opt=repl,
        obs_z=sharded, obs_lm=sharded,
        path_edge=sharded, path_sign=sharded, obs_valid=sharded,
        whitener=repl, sensor_pose_inv=repl,
        calib=calib_spec,
        edge_prior=None if batch.edge_prior is None else repl,
        edge_prior_w=None if batch.edge_prior_w is None else repl,
        iters_cap=None if batch.iters_cap is None else repl,
    )


@functools.lru_cache(maxsize=None)
def _get_spmd_impl(cfg: SolverConfig):
    assert cfg.axis_name == OBS_AXIS
    return make_solver_impl(cfg)


_SPMD_SOLVER_CACHE: dict = {}


def make_spmd_solver(cfg: SolverConfig, mesh: Mesh):
    """Build the sharded solver: ``solve(batch) -> (edge_pose, lm_state,
    info)`` where ``batch``'s observation arrays are (logically) sharded over
    the mesh's ``obs`` axis.  The batch's padded observation count must be a
    multiple of the mesh size (window buckets are powers of two, so any
    power-of-two mesh divides them).  Cached per (cfg, mesh) so the engine
    can call it on every solve without retracing."""
    if cfg.axis_name != OBS_AXIS:
        cfg = dataclasses.replace(cfg, axis_name=OBS_AXIS)
    cache_key = (cfg, tuple(mesh.shape.items()),
                 tuple(d.id for d in mesh.devices.flat))
    hit = _SPMD_SOLVER_CACHE.get(cache_key)
    if hit is not None:
        return hit
    solve_impl, eval_impl = _get_spmd_impl(cfg)

    def _wrap(impl, out_specs_fn):
        # One jitted shard_map per calib pytree STRUCTURE (specs depend on
        # the batch only through it) — rebuilding the wrapper per call would
        # give jax.jit a fresh function identity every time and defeat its
        # executable cache (full retrace per solve).
        cache: dict = {}

        def run(batch: WindowBatch):
            key = jax.tree.structure(batch)
            fn = cache.get(key)
            if fn is None:
                specs = _batch_specs(batch)
                fn = jax.jit(jax.shard_map(
                    impl, mesh=mesh, in_specs=(specs,),
                    out_specs=out_specs_fn(), check_vma=False))
                cache[key] = fn
            return fn(batch)
        return run

    def solve_out_specs():
        repl = P()
        info_specs = {k: repl for k in
                      ("err_init", "err_final", "iters", "lam", "num_obs")}
        return (repl, repl, info_specs)

    out = (_wrap(solve_impl, solve_out_specs), _wrap(eval_impl, lambda: P()))
    _SPMD_SOLVER_CACHE[cache_key] = out
    return out


def shard_batch(batch: WindowBatch, mesh: Mesh) -> WindowBatch:
    """Place a host-built WindowBatch onto the mesh with the solver's
    shardings (obs tables split over devices, the rest replicated)."""
    specs = _batch_specs(batch)
    return jax.tree.map(
        lambda x, s: (None if x is None
                      else jax.device_put(x, NamedSharding(mesh, s))),
        batch, specs,
        is_leaf=lambda x: x is None,
    )
