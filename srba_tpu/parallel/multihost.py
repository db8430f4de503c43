"""Multi-host execution — the collective backend + host-graph sync protocol.

The reference is single-process/single-threaded (SURVEY.md §3.1: no MPI /
NCCL / threads anywhere); multi-host operation is the rebuild's genuinely
new axis (§8 M4, BASELINE.json north star "≥70% linear scaling ... multi-host
pod slice").  The JAX-native answer to "NCCL/MPI" is:

* ``jax.distributed.initialize`` — one JAX process per host, all chips in
  one global view; XLA lowers ``psum``/``all_gather`` onto the backend's
  collectives (NCCL on GPUs, gloo on the CPU test rings).  Nothing in the solver code changes: the
  obs-sharded LM (``parallel/sharding.py``), the window-sharded sweep
  (``solver/multi_window.py``) and the edge-sharded PGO
  (``solver/global_graphslam.py``) all run unmodified over a *global* mesh —
  each process passes its identical full host-built arrays and JAX places
  per-device shards locally (host data is process-replicated by
  construction, see below).

* **Host-graph sync protocol**: SLAM input (the per-keyframe observation
  list) arrives at ONE host — the coordinator (process 0).  Every keyframe
  is encoded into a fixed-shape wire record and broadcast to all processes
  through the device fabric (``multihost_utils.broadcast_one_to_all`` — a
  psum under the hood, riding the device collectives, not a side-channel
  socket).  Every
  process then replays the record into its local replica of the host graph
  (SoA tables + spanning trees + ECP), so all hosts take bit-identical
  topology decisions with zero further messages.  The graph is tiny
  (int arrays) next to the numeric work; replicating it buys determinism
  and keeps every host able to build any window.

The numeric work IS distributed: observation tables are sharded over the
global mesh and the partial normal equations psum-reduce across hosts (the
distributed Schur reduction of SURVEY.md §3.1).

Testable without a pod: CPU processes on one machine with
``--xla_force_host_platform_device_count`` form a real multi-process gloo
ring (see ``tests/test_multihost.py`` — 2 OS processes x 2 devices).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

OBS_AXIS = "obs"


# ---------------------------------------------------------------------------
# Runtime wiring
# ---------------------------------------------------------------------------

def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-process JAX runtime (no-op for single-process runs —
    call unconditionally).  On real pods the three arguments come from the
    cluster environment and may all be ``None`` (auto-detected); for
    manual/local meshes pass them explicitly.

    Must run before the first JAX computation.  For CPU test rings set
    ``JAX_PLATFORMS=cpu`` and ``--xla_force_host_platform_device_count=N``
    in ``XLA_FLAGS`` *before importing jax*.
    """
    import jax
    if num_processes is not None and num_processes <= 1 \
            and coordinator_address is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def process_index() -> int:
    import jax
    return jax.process_index()


def process_count() -> int:
    import jax
    return jax.process_count()


def is_coordinator() -> bool:
    return process_index() == 0


def global_mesh(axis_name: str = OBS_AXIS):
    """1-D mesh over ALL devices of ALL processes (the multi-host analog of
    ``parallel.sharding.make_mesh``)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def broadcast_from_coordinator(tree):
    """Broadcast a pytree of (fixed-shape) host arrays from process 0 to all
    processes through the device fabric.  Every process must pass a tree of
    the same structure/shapes (non-coordinators' values are ignored)."""
    from jax.experimental import multihost_utils
    return multihost_utils.broadcast_one_to_all(tree)


def sync_processes(name: str = "srba") -> None:
    """Barrier across all processes (used around timing sections and before
    teardown so no process exits while peers still expect collectives)."""
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


# ---------------------------------------------------------------------------
# Per-keyframe wire format
# ---------------------------------------------------------------------------

class KeyframeCodec:
    """Fixed-shape encode/decode of one ``define_new_keyframe`` input for
    ``broadcast_one_to_all`` (which requires identical shapes on every
    process — hence padded records, not pickles)."""

    def __init__(self, z_dim: int, lm_dim: int, pose_dim: int,
                 max_obs: int = 256, max_init_edges: int = 8):
        self.z_dim, self.lm_dim, self.pose_dim = z_dim, lm_dim, pose_dim
        self.max_obs, self.max_init_edges = max_obs, max_init_edges

    def zeros(self) -> Dict[str, np.ndarray]:
        M, E = self.max_obs, self.max_init_edges
        return {
            "n_obs": np.int32(0),
            "lm_ids": np.zeros(M, np.int32),
            "z": np.zeros((M, self.z_dim), np.float32),
            "has_fixed": np.zeros(M, np.int32),
            "has_init": np.zeros(M, np.int32),
            "rel": np.zeros((M, self.lm_dim), np.float32),
            "n_edges": np.int32(0),
            "e_targets": np.zeros(E, np.int32),
            "e_poses": np.zeros((E, self.pose_dim), np.float32),
            "run_opt": np.int32(1),
            "stop": np.int32(0),
            # Padding slot in a BATCHED broadcast (see
            # MultiHostEngine.broadcast_batch): replay ignores the record.
            "skip": np.int32(0),
        }

    def encode(self, observations, edge_init, run_opt: bool,
               stop: bool = False) -> Dict[str, np.ndarray]:
        msg = self.zeros()
        if stop:
            msg["stop"] = np.int32(1)
            return msg
        n = len(observations)
        if n > self.max_obs:
            raise ValueError(
                f"{n} observations exceed the wire cap max_obs="
                f"{self.max_obs}; raise MultiHostEngine(max_obs_per_kf=...)")
        msg["n_obs"] = np.int32(n)
        for i, o in enumerate(observations):
            msg["lm_ids"][i] = int(o.lm_id)
            msg["z"][i] = np.asarray(o.z, np.float32)
            if o.fixed_rel_pos is not None:
                msg["has_fixed"][i] = 1
                msg["rel"][i] = np.asarray(o.fixed_rel_pos, np.float32)
            elif o.init_rel_pos is not None:
                msg["has_init"][i] = 1
                msg["rel"][i] = np.asarray(o.init_rel_pos, np.float32)
        if edge_init:
            items = list(edge_init.items())
            if len(items) > self.max_init_edges:
                raise ValueError(
                    f"{len(items)} edge inits exceed the wire cap "
                    f"max_init_edges={self.max_init_edges}")
            msg["n_edges"] = np.int32(len(items))
            for i, (t, p) in enumerate(items):
                msg["e_targets"][i] = int(t)
                msg["e_poses"][i] = np.asarray(p, np.float32)
        msg["run_opt"] = np.int32(1 if run_opt else 0)
        return msg

    def decode(self, msg):
        """-> (observations, edge_init, run_opt, stop)."""
        from srba_tpu.engine.engine import Observation
        msg = {k: np.asarray(v) for k, v in msg.items()}
        if int(msg["stop"]):
            return None, None, False, True
        obs: List[Any] = []
        for i in range(int(msg["n_obs"])):
            obs.append(Observation(
                lm_id=int(msg["lm_ids"][i]),
                z=np.asarray(msg["z"][i], np.float32),
                fixed_rel_pos=(np.asarray(msg["rel"][i], np.float32)
                               if int(msg["has_fixed"][i]) else None),
                init_rel_pos=(np.asarray(msg["rel"][i], np.float32)
                              if int(msg["has_init"][i]) else None),
            ))
        edge_init = None
        n_e = int(msg["n_edges"])
        if n_e:
            edge_init = {int(msg["e_targets"][i]):
                         np.asarray(msg["e_poses"][i], np.float32)
                         for i in range(n_e)}
        return obs, edge_init, bool(int(msg["run_opt"])), False


# ---------------------------------------------------------------------------
# The multi-host engine frontend
# ---------------------------------------------------------------------------

class MultiHostEngine:
    """SPMD wrapper around :class:`SrbaEngine` for multi-process runs.

    Every process constructs an identical engine replica (host graph + SoA
    tables).  The coordinator feeds real observations; every keyframe is
    broadcast (see module docstring) and replayed everywhere, after which
    the local LM+Schur solve runs obs-sharded over the GLOBAL mesh — each
    host's devices handle their observation shard and the normal equations
    psum across hosts.

    On non-coordinator processes call ``define_new_keyframe()`` with no
    arguments (a pure participate-in-broadcast call), or use :meth:`serve`
    to loop until the coordinator broadcasts a stop record.

    ``broadcast_batch=B`` amortizes the per-keyframe protocol cost: the
    coordinator buffers B encoded records and ships them as ONE
    ``broadcast_one_to_all`` of a [B]-stacked pytree; every process then
    replays the B keyframes back-to-back.  The protocol cost per keyframe
    drops ~B-fold (one collective latency + one codec round per batch)
    at the price of B frames of input latency — the right trade for
    throughput-oriented/offline runs (measured: the round-4 unbatched
    protocol cost 122 ms/KF on localhost gloo, 57%% of the per-KF budget).
    With ``B > 1`` the per-call return contract changes: the coordinator
    returns ``None`` while buffering and the list of the batch's
    ``TNewKeyFrameInfo`` at each flush; followers return one such list per
    broadcast round (``None`` on stop).
    """

    def __init__(self, obs_model: str, max_obs_per_kf: int = 256,
                 max_init_edges: int = 8, mesh=None,
                 broadcast_batch: int = 1, **engine_kwargs):
        from srba_tpu.engine.engine import SrbaEngine
        engine_kwargs.setdefault("device_master", False)
        self.mesh = mesh if mesh is not None else global_mesh()
        self.engine = SrbaEngine(obs_model, mesh=self.mesh, **engine_kwargs)
        self.broadcast_batch = max(1, int(broadcast_batch))
        self._buf: List[Dict[str, np.ndarray]] = []
        self.codec = KeyframeCodec(
            z_dim=self.engine.model.z_dim,
            lm_dim=self.engine.lm_type.dim,
            pose_dim=self.engine.group.dim,
            max_obs=max_obs_per_kf, max_init_edges=max_init_edges)

    # -- the synchronized per-frame step ------------------------------------

    def _broadcast_round(self, msgs):
        """One collective round: pad ``msgs`` to the batch size with skip
        records, broadcast, replay every real record locally.  Returns
        ``(infos, stopped)``."""
        B = self.broadcast_batch
        assert len(msgs) <= B
        while len(msgs) < B:
            m = self.codec.zeros()
            m["skip"] = np.int32(1)
            msgs.append(m)
        if B == 1:
            batch = broadcast_from_coordinator(msgs[0])
            rows = [batch]
        else:
            batch = {k: np.stack([m[k] for m in msgs]) for k in msgs[0]}
            batch = {k: np.asarray(v)
                     for k, v in broadcast_from_coordinator(batch).items()}
            rows = [{k: v[i] for k, v in batch.items()} for i in range(B)]
        infos = []
        for row in rows:
            if int(np.asarray(row.get("skip", 0))):
                continue
            obs, e_init, run_opt, stop = self.codec.decode(row)
            if stop:
                return infos, True
            infos.append(self.engine.define_new_keyframe(
                obs, run_local_optimization=run_opt, edge_init=e_init))
        return infos, False

    def define_new_keyframe(self, observations: Optional[Sequence] = None,
                            run_local_optimization: bool = True,
                            edge_init: Optional[dict] = None):
        """Coordinator: pass the real observation list.  Others: call with
        ``observations=None`` to receive keyframes.  With
        ``broadcast_batch == 1`` (default) returns the local replica's
        ``TNewKeyFrameInfo`` (``None`` on a stop record); batched-contract
        returns are documented in the class docstring."""
        if is_coordinator():
            if observations is None:
                raise ValueError("coordinator must supply observations")
            msg = self.codec.encode(observations, edge_init,
                                    run_local_optimization)
            if self.broadcast_batch == 1:
                infos, _ = self._broadcast_round([msg])
                return infos[0]
            self._buf.append(msg)
            if len(self._buf) < self.broadcast_batch:
                return None
            msgs, self._buf = self._buf, []
            infos, _ = self._broadcast_round(msgs)
            return infos
        infos, stopped = self._broadcast_round([])
        if stopped:
            return None
        return infos[0] if self.broadcast_batch == 1 else infos

    def flush(self):
        """Coordinator: broadcast any buffered partial batch now (call
        before a collective operation that must see every fed keyframe,
        e.g. a mid-run ``optimize_global``).  Followers consume it as an
        ordinary (partially skip-padded) round."""
        assert is_coordinator()
        if not self._buf:
            return []
        msgs, self._buf = self._buf, []
        infos, _ = self._broadcast_round(msgs)
        return infos

    def stop(self) -> None:
        """Coordinator: flush buffered keyframes, then release
        :meth:`serve` loops on the other processes."""
        assert is_coordinator()
        self._buf.append(self.codec.encode([], None, False, stop=True))
        msgs, self._buf = self._buf, []
        for i in range(0, len(msgs), self.broadcast_batch):
            self._broadcast_round(msgs[i: i + self.broadcast_batch])

    def serve(self) -> int:
        """Non-coordinator event loop: replay broadcast keyframes until the
        coordinator sends stop.  Returns the number of keyframes processed."""
        assert not is_coordinator()
        n = 0
        while True:
            infos, stopped = self._broadcast_round([])
            n += len(infos)
            if stopped:
                return n

    # -- global refinement over the same mesh --------------------------------

    def optimize_global(self, cfg=None, write_back: bool = True,
                        periodic: bool = False, use_edge_info: bool = False):
        """Distributed global PGO: edge tables sharded over the global mesh
        (every host holds the identical exported problem; see
        :func:`srba_tpu.solver.global_graphslam.make_pgo_spmd`).  With
        ``broadcast_batch > 1`` the coordinator must :meth:`flush` at the
        same point every process calls this (collective alignment)."""
        return self.engine.optimize_global(cfg, write_back=write_back,
                                           mesh=self.mesh, periodic=periodic,
                                           use_edge_info=use_edge_info)

    # -- passthroughs ---------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.engine, name)
