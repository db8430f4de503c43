"""Device-resident master-state solver step — the M3 performance core.

Motivation: a host<->device synchronization blocks the host until the
device queue drains, while dispatches and small uploads are cheap and
fully async.  A per-keyframe pipeline that downloads each optimized window
pays one such blocking round-trip per keyframe, so the host and the device
take turns instead of overlapping.

This module removes the synchronization entirely:

* The kf2kf edge poses and landmark states live in persistent, padded
  **device master arrays** (the authoritative copy; the host keeps a lazily
  refreshed mirror for export/eval only).
* Per keyframe the host uploads (a) the few new edge/landmark rows and
  (b) one packed int32 buffer describing the window (gather indices,
  opt masks, spanning-tree paths) plus the window's observation rows.
* ONE donated jitted program appends the new rows
  (``lax.dynamic_update_slice``), gathers the window from the masters, runs
  the LM+Schur loop (:func:`srba_tpu.solver.lm.make_solver_impl`), and
  scatters the optimized values back with a masked delta ``.at[ids].add``
  (padded slots carry ``opt=0`` so duplicate pad indices contribute exact
  zeros — no scatter nondeterminism).
* Nothing is downloaded: JAX async dispatch lets the host build keyframe
  ``k+1``'s window while the device still optimizes keyframe ``k``.

Reference analog: this replaces the host-side write-back of
``impl/optimize_edges.h`` and the numeric spanning-tree refresh of
``impl/spantree_update_numeric.h`` (public MRPT/srba layout) — numeric state
never leaves the device between keyframes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from srba_tpu.solver.lm import SolverConfig, WindowBatch, make_solver_impl

INFO_KEYS = ("err_init", "err_final", "iters", "lam", "num_obs")


def pack_window_ints(edge_ids, edge_opt, lm_ids, lm_opt, obs_lm, obs_valid,
                     path_edge, path_sign) -> np.ndarray:
    """Flatten the window's integer structure into ONE int32 upload buffer
    (layout mirrored by the static unpack inside :func:`make_master_step`)."""
    return np.concatenate([
        np.asarray(edge_ids, np.int32),
        np.asarray(edge_opt, np.int32),
        np.asarray(lm_ids, np.int32),
        np.asarray(lm_opt, np.int32),
        np.asarray(obs_lm, np.int32),
        np.asarray(obs_valid, np.int32),
        np.asarray(path_edge, np.int32).reshape(-1),
        np.asarray(path_sign, np.int32).reshape(-1),
    ])


@functools.lru_cache(maxsize=None)
def make_master_step(cfg: SolverConfig):
    """Build the donated jitted per-keyframe program.

    Returns ``step(pose_master, lm_master, wire, whitener,
    sensor_pose_inv, calib, E, L, N, pad_e, pad_l, z_dim) ->
    (pose_master', lm_master', info)`` where the trailing six are static
    bucket sizes (jit specializes per combination; buckets are powers of two
    with an emit ratchet so a run touches ~2-4 shapes).  Globally cached by
    config so every engine instance with the same problem configuration
    shares the compiled executables (whitener / sensor pose / calibration
    are device-resident runtime operands, not baked constants).

    ``wire`` (f32) packs ``pad_e`` new edge poses, then ``pad_e`` new edge
    prior rows ([prior pose || weight]), then ``pad_l`` new landmark states
    (garbage rows beyond the real counts land in not-yet-allocated master
    slots and are overwritten by the next append), then the flattened
    ``[N, z_dim]`` window observations, then the BITCAST int32 structure:
    append offsets + the :func:`pack_window_ints` buffer.
    """
    solve_impl, _ = make_solver_impl(cfg)
    D = cfg.max_depth

    @functools.partial(jax.jit, static_argnums=(7, 8, 9, 10, 11, 12),
                       donate_argnums=(0, 1, 2))
    def step(pose_master, prior_master, lm_master, wire,
             whitener, sensor_pose_inv, calib,
             E, L, N, pad_e, pad_l, z_dim):
        pose_dim = pose_master.shape[1]
        lm_dim = lm_master.shape[1]
        pd1 = pose_dim + 1
        # ONE upload buffer per keyframe (each device_put is a separate
        # host->device transfer): ``wire`` is f32 and packs the new
        # rows, the window obs values, then the BITCAST int32 window
        # structure (append offsets + pack_window_ints) — exact bit
        # round-trip, recovered here with bitcast_convert_type.
        rows_len = pad_e * (pose_dim + pd1) + pad_l * lm_dim
        new_rows = wire[:rows_len]
        obs_z = wire[rows_len: rows_len + N * z_dim].reshape(N, z_dim)
        ints_all = jax.lax.bitcast_convert_type(
            wire[rows_len + N * z_dim:], jnp.int32)
        offsets = ints_all[:2]
        iters_cap = ints_all[2]   # runtime LM iteration cap (see WindowBatch)
        ints = ints_all[3:]

        # -- append this keyframe's new rows into the masters --------------
        if pad_e:
            new_edges = new_rows[: pad_e * pose_dim].reshape(pad_e, pose_dim)
            pose_master = jax.lax.dynamic_update_slice(
                pose_master, new_edges, (offsets[0], 0))
            new_priors = new_rows[
                pad_e * pose_dim: pad_e * (pose_dim + pd1)
            ].reshape(pad_e, pd1)
            prior_master = jax.lax.dynamic_update_slice(
                prior_master, new_priors, (offsets[0], 0))
        if pad_l:
            new_lms = new_rows[pad_e * (pose_dim + pd1):].reshape(
                pad_l, lm_dim)
            lm_master = jax.lax.dynamic_update_slice(
                lm_master, new_lms, (offsets[1], 0))

        # -- unpack the window structure (static slicing) -------------------
        o = 0

        def take(n):
            nonlocal o
            s = ints[o: o + n]
            o += n
            return s

        edge_ids = take(E)
        edge_opt = take(E).astype(jnp.float32)
        lm_ids = take(L)
        lm_opt = take(L).astype(jnp.float32)
        obs_lm = take(N)
        obs_valid = take(N).astype(jnp.float32)
        path_edge = take(N * D).reshape(N, D)
        path_sign = take(N * D).reshape(N, D).astype(jnp.float32)

        # -- gather window state from the masters ---------------------------
        edge_pose = pose_master[edge_ids]
        prior_rows = prior_master[edge_ids]
        lm_state = lm_master[lm_ids]

        batch = WindowBatch(
            edge_pose=edge_pose, edge_opt=edge_opt,
            lm_state=lm_state, lm_opt=lm_opt,
            obs_z=obs_z, obs_lm=obs_lm,
            path_edge=path_edge, path_sign=path_sign, obs_valid=obs_valid,
            whitener=whitener, sensor_pose_inv=sensor_pose_inv, calib=calib,
            edge_prior=prior_rows[:, :pose_dim],
            edge_prior_w=prior_rows[:, pose_dim],
            iters_cap=iters_cap)
        new_edge, new_lm, info = solve_impl(batch)

        # -- scatter optimized values back (masked deltas: pad slots add 0) -
        dp = (new_edge - edge_pose) * edge_opt[:, None]
        dl = (new_lm - lm_state) * lm_opt[:, None]
        pose_master = pose_master.at[edge_ids].add(dp)
        lm_master = lm_master.at[lm_ids].add(dl)
        return pose_master, prior_master, lm_master, info

    return step


@functools.lru_cache(maxsize=None)
def make_append_only(pose_dim: int, lm_dim: int):
    """Append-only program for keyframes that skip local optimization
    (``run_local_optimization=False`` / the very first keyframe).  Globally
    cached so engines sharing dims share executables."""

    pd1 = pose_dim + 1

    @functools.partial(jax.jit, static_argnums=(5, 6),
                       donate_argnums=(0, 1, 2))
    def append(pose_master, prior_master, lm_master, new_rows, offsets,
               pad_e, pad_l):
        if pad_e:
            new_edges = new_rows[: pad_e * pose_dim].reshape(pad_e, pose_dim)
            pose_master = jax.lax.dynamic_update_slice(
                pose_master, new_edges, (offsets[0], 0))
            new_priors = new_rows[
                pad_e * pose_dim: pad_e * (pose_dim + pd1)
            ].reshape(pad_e, pd1)
            prior_master = jax.lax.dynamic_update_slice(
                prior_master, new_priors, (offsets[0], 0))
        if pad_l:
            new_lms = new_rows[pad_e * (pose_dim + pd1):].reshape(
                pad_l, lm_dim)
            lm_master = jax.lax.dynamic_update_slice(
                lm_master, new_lms, (offsets[1], 0))
        return pose_master, prior_master, lm_master

    return append


@functools.partial(jax.jit, static_argnums=(1,), donate_argnums=())
def grow_master(master, new_cap: int):
    """Capacity growth on device (no host round-trip): zero-padded copy."""
    out = jnp.zeros((new_cap, master.shape[1]), master.dtype)
    return jax.lax.dynamic_update_slice(out, master, (0, 0))
