"""DeviceMaster — persistent device-resident copies of the pose/landmark
unknowns, with staged appends and zero-download per-keyframe stepping.

See :mod:`srba_tpu.solver.master` for the rationale (a blocking
device->host synchronization per keyframe drains the async dispatch
queue).  This class owns:

* the padded master arrays (power-of-two capacity, grown on device),
* the staging queues of new edge/landmark rows created since the last
  device dispatch,
* the lazily synchronized host mirror (``sync_to_host``).

The reference keeps all numeric state in host STL containers
(``TRBA_Problem_state`` in ``include/srba/srba_types.h``, public MRPT/srba
layout); here the device is authoritative between keyframes and the host
mirror is refreshed only for export/eval/checkpoint.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from srba_tpu.solver.master import (INFO_KEYS, grow_master, make_append_only,
                                    make_master_step, pack_window_ints)


def _bucket_pow2(n: int, minimum: int) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class LazyInfo(dict):
    """``TOptimizeExtraOutputInfo``-style dict whose values stay on device
    until first read — reading any value costs one blocking download, so
    the steady-state per-keyframe loop never pays it."""

    def __init__(self, dev_info):
        super().__init__()
        self._dev = dev_info

    def _fetch(self):
        if self._dev is not None:
            import jax
            vals = jax.device_get(self._dev)
            for k, v in vals.items():
                super().__setitem__(k, float(v))
            self._dev = None

    def __getitem__(self, k):
        self._fetch()
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._fetch()
        return super().get(k, default)

    def __contains__(self, k):
        return k in INFO_KEYS if self._dev is not None \
            else super().__contains__(k)

    def keys(self):
        return iter(INFO_KEYS) if self._dev is not None else super().keys()

    def items(self):
        self._fetch()
        return super().items()

    def values(self):
        self._fetch()
        return super().values()

    def __iter__(self):
        return self.keys()

    def __len__(self):
        return len(INFO_KEYS) if self._dev is not None else super().__len__()

    def __repr__(self):
        self._fetch()  # repr is a debug path; users want numbers
        return dict.__repr__(self)


class DeviceMaster:
    """Device-authoritative master arrays + staging + jit-dispatch frontend."""

    # Generous initial capacities: growth recompiles the step program, so
    # start big — a few MB of device memory buys away almost all growth
    # events (16k edges / 64k landmarks ≈ 1.2 MB at SE(3) dims).
    INIT_EDGE_CAP = 16384
    INIT_LM_CAP = 65536
    PAD_E_MIN = 8
    PAD_L_MIN = 64

    def __init__(self, pose_dim: int, lm_dim: int):
        import jax.numpy as jnp

        self.pose_dim = pose_dim
        self.lm_dim = lm_dim
        self.pose = jnp.zeros((self.INIT_EDGE_CAP, pose_dim), jnp.float32)
        # Edge measurement priors: [prior pose || weight] per edge row,
        # appended in lockstep with ``pose`` (write-once; never scattered).
        self.prior = jnp.zeros((self.INIT_EDGE_CAP, pose_dim + 1),
                               jnp.float32)
        self.lm = jnp.zeros((self.INIT_LM_CAP, lm_dim), jnp.float32)
        self.num_edges = 0          # rows materialized on device
        self.num_lms = 0
        self._pend_edges: List[np.ndarray] = []
        self._pend_priors: List[np.ndarray] = []
        self._pend_lms: List[np.ndarray] = []
        self._append_fn = make_append_only(pose_dim, lm_dim)
        # Mirror freshness is tracked by SEQUENCE, not a boolean: step_seq
        # counts device-state mutations (optimization steps); mirror_seq is
        # the step the host mirror reflects.  Staleness-tolerant consumers
        # (the loop-closure bootstrap) accept mirrors up to N steps old,
        # which converts a blocking sync per closure-voting keyframe into
        # one overlapped async prefetch per N steps.
        self.step_seq = 0
        self.mirror_seq = 0
        self._prefetch = None       # (pose_buf, lm_buf, n_e, n_l, seq)
        # Mirror-sync accounting (prefetch hit vs blocking-fetch miss, with
        # blocked seconds) — surfaced in the engine's --profile-stats table.
        self.sync_stats = {"pf_hit": 0, "pf_hit_s": 0.0,
                           "miss": 0, "miss_s": 0.0}
        # Device-resident per-engine operands (uploaded once on first step).
        self._whitener_dev = None
        self._spinv_dev = None
        self._calib_dev = None

    # -- staging -------------------------------------------------------------

    def stage_edge(self, pose_row: np.ndarray, prior_w: float = 0.0) -> None:
        row = np.asarray(pose_row, np.float32)
        self._pend_edges.append(row)
        self._pend_priors.append(
            np.concatenate([row, [np.float32(prior_w)]]))

    def stage_landmark(self, lm_row: np.ndarray) -> None:
        self._pend_lms.append(np.asarray(lm_row, np.float32))

    def _take_staging(self) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Pack pending rows into one padded f32 buffer + offsets; advance
        the device row counts.  Pad rows repeat the last real row (or zeros)
        — they land in not-yet-allocated slots and get overwritten by the
        next append before any gather can reach them."""
        n_e, n_l = len(self._pend_edges), len(self._pend_lms)
        pad_e = _bucket_pow2(max(n_e, 1), self.PAD_E_MIN)
        pad_l = _bucket_pow2(max(n_l, 1), self.PAD_L_MIN)
        pd1 = self.pose_dim + 1
        rows = np.zeros(pad_e * (self.pose_dim + pd1) + pad_l * self.lm_dim,
                        np.float32)
        if n_e:
            rows[: n_e * self.pose_dim] = np.concatenate(
                [r.ravel() for r in self._pend_edges])
            base = pad_e * self.pose_dim
            rows[base: base + n_e * pd1] = np.concatenate(
                [r.ravel() for r in self._pend_priors])
        if n_l:
            base = pad_e * (self.pose_dim + pd1)
            rows[base: base + n_l * self.lm_dim] = np.concatenate(
                [r.ravel() for r in self._pend_lms])
        offsets = np.asarray([self.num_edges, self.num_lms], np.int32)
        self._ensure_capacity(self.num_edges + pad_e, self.num_lms + pad_l)
        self.num_edges += n_e
        self.num_lms += n_l
        self._pend_edges.clear()
        self._pend_priors.clear()
        self._pend_lms.clear()
        return rows, offsets, pad_e, pad_l

    def _ensure_capacity(self, n_edges: int, n_lms: int) -> None:
        ecap = self.pose.shape[0]
        if n_edges > ecap:
            while ecap < n_edges:
                ecap *= 4
            self.pose = grow_master(self.pose, ecap)
            self.prior = grow_master(self.prior, ecap)
        lcap = self.lm.shape[0]
        if n_lms > lcap:
            while lcap < n_lms:
                lcap *= 4
            self.lm = grow_master(self.lm, lcap)

    # -- dispatch ------------------------------------------------------------

    def flush_append(self) -> None:
        """Append staged rows without optimizing (first KF / opt disabled)."""
        if not self._pend_edges and not self._pend_lms:
            return
        rows, offsets, pad_e, pad_l = self._take_staging()
        self.pose, self.prior, self.lm = self._append_fn(
            self.pose, self.prior, self.lm, rows, offsets, pad_e, pad_l)

    def step(self, cfg, whitener, sensor_pose_inv, calib,
             edge_ids, edge_opt, lm_ids, lm_opt, obs_lm, obs_valid,
             path_edge, path_sign, obs_z, iters_cap: int = 0) -> LazyInfo:
        """Append staged rows + solve one window, all in one dispatch.
        One host->device upload per keyframe (the f32 ``wire`` buffer, with
        the int32 window structure bitcast into its tail).
        ``iters_cap`` (0 = config max) is a RUNTIME LM iteration cap rode
        along in the int buffer — no recompile per value."""
        import jax.numpy as jnp

        rows, offsets, pad_e, pad_l = self._take_staging()
        ints = pack_window_ints(edge_ids, edge_opt, lm_ids, lm_opt,
                                obs_lm, obs_valid, path_edge, path_sign)
        obs_z = np.asarray(obs_z, np.float32)
        cap = np.asarray([iters_cap if iters_cap > 0 else cfg.max_iters],
                         np.int32)
        wire = np.concatenate([
            rows, obs_z.ravel(),
            np.concatenate([offsets, cap, ints]).view(np.float32)])
        if self._whitener_dev is None:
            import jax
            self._whitener_dev = jnp.asarray(whitener, jnp.float32)
            self._spinv_dev = jnp.asarray(sensor_pose_inv, jnp.float32)
            self._calib_dev = jax.tree.map(jnp.asarray, calib)
        fn = make_master_step(cfg)  # global per-config executable cache
        E, L, N = len(edge_ids), len(lm_ids), len(obs_lm)
        self.pose, self.prior, self.lm, info = fn(
            self.pose, self.prior, self.lm, jnp.asarray(wire),
            self._whitener_dev, self._spinv_dev, self._calib_dev,
            E, L, N, pad_e, pad_l, obs_z.shape[1])
        self.step_seq += 1
        return LazyInfo(info)

    def fence(self) -> None:
        """Drain the async device queue WITHOUT downloading anything
        (blocking on the latest master array waits for every queued
        step)."""
        import jax
        jax.block_until_ready(self.pose)

    # -- host mirror -----------------------------------------------------------

    @property
    def dirty(self) -> bool:
        """Device ahead of the host mirror (seq-derived; settable for
        compatibility: ``True`` bumps the step sequence — e.g. after a
        refine-map sweep — and ``False`` marks the mirror current)."""
        return self.mirror_seq < self.step_seq

    @dirty.setter
    def dirty(self, value: bool) -> None:
        if value:
            self.step_seq += 1
        else:
            self.mirror_seq = self.step_seq

    def _live_buckets(self):
        b_e = min(_bucket_pow2(max(self.num_edges, 1), self.PAD_E_MIN),
                  self.pose.shape[0])
        b_l = min(_bucket_pow2(max(self.num_lms, 1), self.PAD_L_MIN),
                  self.lm.shape[0])
        return b_e, b_l

    def maybe_prefetch(self, max_age: int, force: bool = False) -> None:
        """Start (if useful) an ASYNC device->host copy of the live master
        slices so a later staleness-tolerant ``sync_to_host(max_age=...)``
        consumes it without a blocking download.  A prefetch taken at
        step ``s`` stays consumable until ``step_seq == s + max_age``, so a
        new one is issued once the in-flight copy has burned half that
        budget — cadence ``max_age/2`` steps, which also gives each copy
        ~that many frames to land before anyone needs it.  ``force`` issues
        a fresh copy of the CURRENT step regardless of cadence (used right
        after an accepted closure's refinement step, whose post-closure
        state the next bootstrap must see)."""
        if self.mirror_seq >= self.step_seq:
            return
        pf_seq = self._prefetch[4] if self._prefetch is not None \
            else self.mirror_seq
        if force:
            if pf_seq >= self.step_seq:
                return
        elif self.step_seq - pf_seq < max(1, max_age // 2):
            return
        b_e, b_l = self._live_buckets()
        pose, lm = self.pose[:b_e], self.lm[:b_l]
        pose.copy_to_host_async()
        lm.copy_to_host_async()
        self._prefetch = (pose, lm, self.num_edges, self.num_lms,
                          self.step_seq)

    def sync_to_host(self, k2k_pose: np.ndarray, lm_state: np.ndarray,
                     max_age: int = 0, min_seq: int = 0) -> None:
        """Refresh the host mirror in place (ONE download).  Fetch only a
        power-of-two bucket of the LIVE rows: the full padded masters are
        16k+64k rows; the live slice is typically a few KB.

        ``max_age > 0`` tolerates a mirror up to that many optimization
        steps behind the device (loop-closure bootstrap path: the voter
        landmarks / center-area edges it reads were optimized a full map
        revisit ago and move negligibly per step).  ``min_seq`` is a hard
        freshness floor overriding the age budget — the engine sets it to
        the step of the last ACCEPTED closure's refinement, after which the
        map moves wholesale and pre-closure estimates are not equivalent.
        A pending :meth:`maybe_prefetch` copy satisfying both bounds is
        consumed instead of a blocking fetch."""
        target = max(self.step_seq - max_age, min_seq)
        if self.mirror_seq >= target:
            return
        import time as _time
        pf = self._prefetch
        if pf is not None:
            pose_b, lm_b, n_e, n_l, seq = pf
            if seq > self.mirror_seq and seq >= target:
                # copy_to_host_async already landed (or nearly): np.asarray
                # blocks only for the remainder of the transfer.
                t0 = _time.perf_counter()
                k2k_pose[:n_e] = np.asarray(pose_b)[:n_e]
                lm_state[:n_l] = np.asarray(lm_b)[:n_l]
                self.sync_stats["pf_hit"] += 1
                self.sync_stats["pf_hit_s"] += _time.perf_counter() - t0
                self.mirror_seq = seq
                self._prefetch = None
                return
        import jax
        t0 = _time.perf_counter()
        n_e, n_l = self.num_edges, self.num_lms
        b_e, b_l = self._live_buckets()
        pose, lm = jax.device_get((self.pose[:b_e], self.lm[:b_l]))
        k2k_pose[:n_e] = pose[:n_e]
        lm_state[:n_l] = lm[:n_l]
        self.sync_stats["miss"] += 1
        self.sync_stats["miss_s"] += _time.perf_counter() - t0
        self.mirror_seq = self.step_seq
        self._prefetch = None

    def upload_from_host(self, k2k_pose: np.ndarray, lm_state: np.ndarray,
                         num_edges: int, num_lms: int,
                         k2k_prior: np.ndarray = None,
                         k2k_prior_w: np.ndarray = None) -> None:
        """Replace device state wholesale (checkpoint load / rebuild).
        Priors default to the uploaded poses with weight 0 (no factors)."""
        import jax.numpy as jnp

        self._pend_edges.clear()
        self._pend_priors.clear()
        self._pend_lms.clear()
        self.num_edges = num_edges
        self.num_lms = num_lms
        ecap = max(self.INIT_EDGE_CAP,
                   _bucket_pow2(num_edges + self.PAD_E_MIN, self.INIT_EDGE_CAP))
        lcap = max(self.INIT_LM_CAP,
                   _bucket_pow2(num_lms + self.PAD_L_MIN, self.INIT_LM_CAP))
        pose = np.zeros((ecap, self.pose_dim), np.float32)
        pose[:num_edges] = k2k_pose[:num_edges]
        prior = np.zeros((ecap, self.pose_dim + 1), np.float32)
        prior[:num_edges, : self.pose_dim] = (
            k2k_prior[:num_edges] if k2k_prior is not None
            else k2k_pose[:num_edges])
        if k2k_prior_w is not None:
            prior[:num_edges, self.pose_dim] = k2k_prior_w[:num_edges]
        lm = np.zeros((lcap, self.lm_dim), np.float32)
        lm[:num_lms] = lm_state[:num_lms]
        self.pose = jnp.asarray(pose)
        self.prior = jnp.asarray(prior)
        self.lm = jnp.asarray(lm)
        self._prefetch = None      # refers to pre-upload device state
        self.dirty = False
