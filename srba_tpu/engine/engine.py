"""SrbaEngine — the public API orchestrator, equivalent of the reference's
``RbaEngine<KF2KF_POSE, LM, OBS, OPTIONS>`` (public MRPT/srba layout:
``include/srba/RbaEngine.h`` + ``impl/define_new_keyframe.h`` /
``impl/alloc_keyframe.h`` / ``impl/add-observations.h``; SURVEY.md §1.2, §4.1,
Appendix B).

The reference's four compile-time template axes become a runtime
``SrbaEngine(...)`` configuration that resolves to jit-compiled XLA
specializations (one per problem config x window-shape bucket).  Per
keyframe: host does the integer work (allocation, edge-creation policy,
spanning-tree symbolic paths, window selection) and the device runs ONE
jitted LM+Schur program over the padded window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from srba_tpu.ecps import ClassicLinearRBA
from srba_tpu.engine.device_master import DeviceMaster
from srba_tpu.engine.state import ProblemState
from srba_tpu.graph.spantree import KeyframeGraph
from srba_tpu.models.landmarks import (LANDMARK_TYPES, Euclidean2D,
                                       Euclidean3D)
from srba_tpu.models.noise import NoiseIdentity
from srba_tpu.models.observations import OBSERVATION_MODELS
from srba_tpu.models.sensor_pose import SensorPoseNone
from srba_tpu.ops.np_lie import compose_path, np_group_for
from srba_tpu.solver.lm import SolverConfig, WindowBatch, get_solver
from srba_tpu.solver.window import build_window, write_back
from srba_tpu.utils.profiler import Profiler


@dataclass
class SrbaParams:
    """Runtime parameters — analog of ``TSRBAParameters`` (reference
    ``RbaEngine.h``): ``parameters.srba.*`` in Appendix B."""

    max_tree_depth: int = 4
    max_optimize_depth: int = 4
    use_robust_kernel: bool = False
    kernel_param: float = 3.0
    verbose: int = 0
    # Window-size bound: keep only the newest N in-window observations per
    # landmark when building a local window (None = all).  Guards against
    # padded-window blowup in dense re-visit regimes (many keyframes
    # re-observing the same landmarks => N_obs grows with visit count, and a
    # giant bucket shape forces a fresh, possibly enormous, XLA compile).
    extra_obs_per_lm_cap: Optional[int] = None
    # Loop-closure bootstrap (engine/closure.py): initialize closure edges
    # from the re-observed landmarks (Kabsch / multi-start PnP) instead of
    # drift-accumulating estimates; monocular fits worse than
    # closure_gate_px RMS are DEFERRED (the ECP re-votes next frames).
    closure_bootstrap: bool = True
    closure_gate_px: float = 25.0
    # Closure observability threshold (meters/radians): a fit whose
    # predicted worst-direction pose sigma (engine/closure.py _fit_sigma)
    # is below this is a STRONG closure; fits up to
    # ``closure_accept_sigma_factor`` times it are still ACCEPTED but carry
    # proportionally lower weight (prior weight and global-PGO information
    # are 1/sigma^2 of the measured value) — weak closures inform without
    # dominating; beyond the factor the fit is deferred (the ECP re-votes
    # on later frames).  None disables sigma gating entirely.
    closure_max_sigma: Optional[float] = 0.3
    closure_accept_sigma_factor: float = 3.0
    # After a closure fit to an area center hard-rejects, skip re-fitting
    # that center for this many keyframes (revisits are contiguous: the
    # next frame's fit uses near-identical voters and fails the same way;
    # measured round 3, the every-frame multi-start PnP retry cost config#5
    # ~40% of its incremental throughput).  Weak/strong fits never cool
    # down — they are cheap (the cached fit seeds the next one into the
    # right basin immediately).
    closure_retry_cooldown: int = 4
    # Keyframes to hold a WEAK closure fit pending before materializing it:
    # within this window a strong fit supersedes it (a weak edge must not
    # preempt a strong one — creating the edge suppresses re-voting); after
    # it, the best weak fit is inserted with weight 1/sigma^2 rather than
    # leaving the area unclosed.
    closure_pending_flush_age: int = 8
    # Edge measurement priors (state.k2k_prior): keep each edge's
    # creation-time measured value (odometry / closure bootstrap) as a weak
    # permanent factor in every window solve, weight 1/sigma^2 (scaled down
    # by hop count for composed dead-reckoned seeds).  Guards against
    # visually degenerate windows (at revisits most visible landmarks are
    # based beyond the tree depth; the few in-window ones can leave a null
    # space that reprojection-only LM slides along by meters — measured:
    # stereo 60-KF loop, edge error 0.016 -> 2.9 m WITH local opt).  None
    # disables the priors.
    edge_prior_sigma: Optional[float] = 0.05
    # Reference sigma for closure-edge information in the global PGO export
    # (io/export.py): a closure whose measured fit sigma equals this keeps
    # its observation-support weight unscaled; stronger/weaker fits scale
    # quadratically (clipped).  Also the sigma assumed for closures whose
    # fit did not run (closure_bootstrap off / "n/a" fallback seeds).
    closure_prior_sigma: float = 0.25
    # Staleness budget (in optimization steps) for the host mirror consumed
    # by the closure SEED cache (`_seed_globals`).  Seeds only pick the
    # basin (the bootstrap refits from measurements), so a mirror a few
    # steps old is equivalent — and tolerating age converts a blocking
    # device->host sync into an overlapped async prefetch.
    closure_mirror_max_age: int = 16
    # Re-verify band for closure fits done on a stale mirror: any fit whose
    # gate ratio is <= this (which includes EVERY accept, ratio <= 1, by
    # design — accepted closures are always settled on exact device state
    # before an edge is inserted) is re-fit against a fresh sync; far
    # rejects (ratio > band) are deferred without a blocking sync, which
    # drains the async solve queue.  What that sync costs on the GPU is
    # ROADMAP S1.
    closure_reverify_band: float = 2.0
    # LM solver knobs
    max_iters: int = 20
    # Iteration cap for ORDINARY per-keyframe incremental steps (runtime
    # scalar — same compiled program as the full budget; applies to every
    # backend: device-master, host, and mesh/SPMD).  Incremental windows
    # overlap across keyframes, so each frame only needs to pull the new
    # edge into the basin; later frames finish the polish (the iSAM-style
    # argument).  Closure-ACTIVE frames (edge created OR voted, even if the
    # fit deferred) and explicit optimize_local_area / optimize_edges calls
    # always run `max_iters`.
    # config#3 stereo 500 KF averaged 15.2 iters/step uncapped (a third
    # hitting the 20-cap) — device-queue backlog that every mirror sync
    # then drained; cap 3 gives the same ATE.  The 5k-KF mono run is the
    # cap-sensitive extreme (drift between closures compounds): ATE
    # 0.86/0.87/1.18 at cap 20/10/5 — 10 is the largest value that still
    # cuts the backlog without moving accuracy, hence the default;
    # short/landmark-dense maps can safely run lower (bench config#3 uses
    # 3).  The caps' effect on GPU throughput is ROADMAP D5.
    incremental_max_iters: int = 10
    lam0: float = 1e-4
    rel_tol: float = 1e-6
    # Solver engine selector (reference: solver_LM_* options):
    # "schur_dense_cholesky" (default) or "no_schur_dense_cholesky".
    solver: str = "schur_dense_cholesky"
    # Monocular front-end (engine/triangulate.py): new landmarks observed
    # without an explicit init are held pending and materialized by
    # two-view midpoint triangulation once a sighting with >= this much
    # parallax exists (buffered observations are replayed).  The reference
    # instead requires callers to supply every mono init.  None disables
    # (restoring the reference's must-supply-init contract).
    mono_min_parallax_deg: Optional[float] = 1.0


@dataclass
class Observation:
    """One landmark sighting handed to ``define_new_keyframe`` (the analog of
    the reference's per-KF observation list entries).

    ``fixed_rel_pos``: landmark with exactly known position in its base frame
    (excluded from optimization).  ``init_rel_pos``: explicit initial value
    for a new unknown landmark (optional for models with an inverse sensor
    model — the default comes from it).  Monocular: with the default
    deferred-triangulation front-end (``SrbaParams.mono_min_parallax_deg``)
    an initless new landmark is buffered and materialized once parallax
    suffices (``add_observation`` returns -1 while pending); with the
    front-end disabled (``mono_min_parallax_deg=None``) an init is REQUIRED
    (``ValueError``), matching the reference's contract."""

    lm_id: int
    z: Any
    fixed_rel_pos: Optional[Any] = None
    init_rel_pos: Optional[Any] = None


@dataclass
class TNewKeyFrameInfo:
    """Result of ``define_new_keyframe`` (reference ``TNewKeyFrameInfo``)."""

    kf_id: int = -1
    created_edge_ids: List[int] = field(default_factory=list)
    optimize_results: Dict[str, float] = field(default_factory=dict)


class SrbaEngine:
    def __init__(
        self,
        obs_model: str,
        lm_type: Optional[str] = None,
        ecp: Any = None,
        noise: Any = None,
        sensor_pose: Any = None,
        calib: Any = None,
        params: Optional[SrbaParams] = None,
        dtype=np.float32,
        device_master: bool = True,
        mesh=None,
    ):
        # SPMD window solves: with a mesh, optimize_local_area runs the
        # obs-sharded solver over it (multi-host capable: every process
        # passes identical full host arrays — see parallel/multihost.py).
        # The single-device device-master fast path is mutually exclusive.
        if mesh is not None:
            device_master = False
        self.mesh = mesh
        self.model = OBSERVATION_MODELS[obs_model]
        self.group = self.model.pose_group
        self.np_group = np_group_for(self.group)
        if lm_type is None:
            if getattr(self.model, "is_pose_landmark", False):
                lm_type = self.model.name  # RelativePoses2D/3D landmark
            else:
                lm_type = (Euclidean2D.name if self.model.lm_dim == 2
                           else Euclidean3D.name)
        self.lm_type = LANDMARK_TYPES[lm_type]
        self.ecp = ecp if ecp is not None else ClassicLinearRBA()
        self.noise = noise if noise is not None else NoiseIdentity(1.0)
        self.sensor_pose = (sensor_pose if sensor_pose is not None
                            else SensorPoseNone())
        self.calib = calib
        self.parameters = params if params is not None else SrbaParams()
        self.profiler = Profiler()

        self.state = ProblemState(
            pose_dim=self.group.dim,
            lm_dim=self.lm_type.dim,
            z_dim=self.model.z_dim,
        )
        self.graph = KeyframeGraph(self.parameters.max_tree_depth)
        # Device-resident master state (M3): the authoritative copy of edge
        # poses and landmark states lives on device; the host numpy tables
        # above become a lazily refreshed mirror.  Avoids a blocking
        # device->host download of every optimized window per keyframe.
        self.device_master = (
            DeviceMaster(self.group.dim, self.lm_type.dim)
            if device_master else None)
        # Native (C++) host graph service (M3): owns the per-keyframe window
        # build on the hot path; the Python graph above keeps serving the
        # public traversal APIs.  Falls back to Python when no toolchain.
        self.native = None
        if device_master:
            try:
                from srba_tpu.native import get_lib
                if get_lib() is not None:
                    from srba_tpu.native.core import NativeCore
                    self.native = NativeCore(self.parameters.max_tree_depth)
            except Exception:
                self.native = None

        self._whitener = np.asarray(
            self.noise.whitener(self.model.obs_dim), np.float32)
        # Host-side (numpy) copy of the calibration for inverse-sensor-model
        # landmark init without any device round-trip.
        if calib is not None:
            import jax
            self._calib_np = jax.tree.map(
                lambda x: np.asarray(jax.device_get(x), np.float32), calib)
        else:
            self._calib_np = None
        sp = np.asarray(self.sensor_pose.pose_for(self.group), np.float32)
        self._sensor_pose = sp
        self._sensor_pose_inv = np.asarray(self.np_group.inverse(sp),
                                           np.float32)
        self._use_sensor_pose = not self.sensor_pose.is_identity

        # External feature id -> dense internal landmark index (the engine
        # accepts arbitrary user landmark ids, like the reference's
        # observation lists keyed by feature id).
        self._lm_id_map: Dict[int, int] = {}
        # Dead-reckoned global pose per KF (host, odometry-composed): seeds
        # primary-link edge initials without device syncs.
        self._G_dr: List[np.ndarray] = []
        # Throttled optimized-global-pose cache for loop-closure seeding:
        # (num_kfs at build, G array, dist map).  Rebuilding costs one device
        # sync + a full spanning-tree compose, so it is refreshed at most
        # every `_seed_cache_max_age` keyframes and extended frame-
        # consistently by dead-reckoned increments in between.
        self._seed_cache = None
        self._seed_cache_max_age = 25
        # Area centers whose last closure fit hard-rejected: center -> first
        # keyframe id allowed to retry (SrbaParams.closure_retry_cooldown).
        self._closure_cooldown: Dict[int, int] = {}
        # Best WEAK closure fit per area center, held pending until a strong
        # fit supersedes it or the flush age passes (SrbaParams.
        # closure_pending_flush_age): center -> {sigma, T, kf, first_kf}.
        self._closure_pending: Dict[int, Dict[str, Any]] = {}
        # Step seq of the last accepted closure's refinement: a stale
        # mirror is never accepted from before this point.
        self._closure_barrier_seq = 0
        self._tri = None   # lazy MonoTriangulator (mono deferred inits)

        self._solver_cfg = SolverConfig(
            obs_model=self.model.name,
            pose_group=self.group.name,
            lm_type=self.lm_type.name,
            max_depth=self.parameters.max_tree_depth,
            use_sensor_pose=self._use_sensor_pose,
            use_robust_kernel=self.parameters.use_robust_kernel,
            kernel_param=self.parameters.kernel_param,
            max_iters=self.parameters.max_iters,
            lam0=self.parameters.lam0,
            rel_tol=self.parameters.rel_tol,
            solver=self.parameters.solver,
        )
        self._eval_fn = None  # built lazily (see eval_overall_squared_error)

    # ------------------------------------------------------------------
    # Internal: state mutation + device staging
    # ------------------------------------------------------------------

    def _add_edge(self, from_kf: int, to_kf: int, pose: np.ndarray,
                  prior_w: float = 0.0, sigma: float = 0.0,
                  info=None) -> int:
        e = self.state.add_edge(from_kf, to_kf, pose, prior_w=prior_w,
                                sigma=sigma, info=info)
        if self.device_master is not None:
            self.device_master.stage_edge(pose, prior_w)
        if self.native is not None:
            self.native.add_edge(from_kf, to_kf)
        return e

    def _add_landmark(self, base_kf: int, st: np.ndarray,
                      fixed: bool = False) -> int:
        l = self.state.add_landmark(base_kf, st, fixed=fixed)
        if self.device_master is not None:
            self.device_master.stage_landmark(st)
        if self.native is not None:
            self.native.add_landmark(base_kf, fixed)
        return l

    def sync(self, max_age: int = 0) -> None:
        """Refresh the host mirror of edge poses / landmark states from the
        device master (one blocking download; no-op when clean or when the
        device-master path is disabled).  ``max_age`` accepts a mirror up to
        that many optimization steps stale (see
        :meth:`DeviceMaster.sync_to_host`); public callers get exactness.
        Staleness never crosses an accepted closure's refinement step (the
        barrier): post-closure the map moves wholesale."""
        if self.device_master is not None:
            self.device_master.sync_to_host(
                self.state.k2k_pose, self.state.lm_state, max_age=max_age,
                min_seq=self._closure_barrier_seq if max_age else 0)

    def fence(self) -> None:
        """Drain all pending async device work WITHOUT downloading state
        (use around timing sections; ``sync`` additionally refreshes the
        host mirror)."""
        if self.device_master is not None:
            self.device_master.fence()

    # ------------------------------------------------------------------
    # Core per-frame API
    # ------------------------------------------------------------------

    def define_new_keyframe(
        self,
        observations: Sequence[Observation],
        run_local_optimization: bool = True,
        edge_init: Optional[Dict[int, Any]] = None,
    ) -> TNewKeyFrameInfo:
        """Add a keyframe with its observations: allocate, run the
        edge-creation policy, ingest observations (initializing new landmarks
        via the inverse sensor model), then locally optimize (SURVEY.md
        §1.2)."""
        info = TNewKeyFrameInfo()
        prof = self.profiler
        with prof.scope("define_new_keyframe"):
            with prof.scope("alloc"):
                kf_id = self.state.add_keyframe()
                self.graph.add_keyframe()
                if self.native is not None:
                    self.native.add_keyframe()
                info.kf_id = kf_id

            known_lms = [self._lm_id_map[o.lm_id] for o in observations
                         if o.lm_id in self._lm_id_map]

            with prof.scope("ecp"):
                out = self.ecp.edges_for_new_kf(
                    self.state, self.graph, kf_id, known_lms)
                if isinstance(out, tuple):
                    primary_targets, closure_targets = out
                else:  # user policy returning a flat list: all primary
                    primary_targets, closure_targets = list(out), []

                # Dead-reckoned global estimate of the NEW keyframe, anchored
                # by any provided edge_init (odometry) — used to seed
                # primary-link edges without any device sync even when the
                # odometry keyframe is not itself a target (local-areas
                # center links).
                G_dr_new = None
                if edge_init:
                    for t0, e0 in edge_init.items():
                        if 0 <= t0 < kf_id and t0 < len(self._G_dr):
                            G_dr_new = self.np_group.compose(
                                self._G_dr[t0],
                                self.np_group.inverse(
                                    np.asarray(e0, np.float32)))
                            break

                def _seed_from(G_new, G_t):
                    # Edge stores T_new<-t;  G[new] = G[t] ∘ inv(T).
                    return np.asarray(self.np_group.compose(
                        self.np_group.inverse(G_new), G_t), np.float32)

                def _seed_globals():
                    """Optimized global estimate, throttled: rebuilt at most
                    every `_seed_cache_max_age` KFs (stale-tolerant sync +
                    spanning-tree compose — the rebuild's remaining cost is
                    the host-side level-batched compose, no blocking sync);
                    newer KFs are covered frame-consistently by dead-reckoned
                    increments from the cache's anchor."""
                    c = self._seed_cache
                    if c is None or (self.state.num_kfs - c[0]
                                     > self._seed_cache_max_age):
                        G, dist = self.create_complete_spanning_tree(
                            0, _mirror_max_age=self.parameters
                            .closure_mirror_max_age)
                        c = (self.state.num_kfs, G, dist)
                        self._seed_cache = c
                    return c

                def _global_est(k):
                    """Global estimate of existing KF k (None if unknown)."""
                    n0, G, dist = _seed_globals()
                    if k < len(G) and k in dist:
                        return G[k]
                    # KF newer than the cache: extend via dead reckoning
                    # from the newest cached KF on the chain.
                    anchor = n0 - 1
                    if anchor in dist and k < len(self._G_dr) \
                            and anchor < len(self._G_dr):
                        return self.np_group.compose(
                            G[anchor], self.np_group.compose(
                                self.np_group.inverse(self._G_dr[anchor]),
                                self._G_dr[k]))
                    return None

                def _global_est_new():
                    """Global estimate of the NEW keyframe (pre-edges)."""
                    if G_dr_new is None:
                        return None
                    n0, G, dist = _seed_globals()
                    anchor = n0 - 1
                    if anchor in dist and anchor < len(self._G_dr):
                        return self.np_group.compose(
                            G[anchor], self.np_group.compose(
                                self.np_group.inverse(self._G_dr[anchor]),
                                G_dr_new))
                    return G_dr_new

                synced_for_boot = False
                closure_created = False
                p_sigma = self.parameters.edge_prior_sigma
                if getattr(self.model, "is_pose_landmark", False):
                    # Graph-SLAM mode: every observation IS a direct edge
                    # measurement, so windows are never visually degenerate
                    # and an odometry prior would double-count/outvote the
                    # loop-closure observations (whose whitened weight the
                    # prior knows nothing about).
                    p_sigma = None
                for which, targets in (("primary", primary_targets),
                                       ("closure", closure_targets)):
                    for t in targets:
                        # Prior weight: how much the seed is a MEASUREMENT
                        # (see SrbaParams.edge_prior_sigma).
                        prior_w = 0.0
                        fit_info = None   # closure fit JtJ (anisotropic)
                        if edge_init is not None and t in edge_init:
                            init = np.asarray(edge_init[t], np.float32)
                            if p_sigma:
                                prior_w = 1.0 / (p_sigma * p_sigma)
                        elif which == "primary" and G_dr_new is not None \
                                and t < len(self._G_dr):
                            # Local link: dead-reckoned seed (drift between
                            # the new KF and a nearby target is tiny).
                            init = _seed_from(G_dr_new, self._G_dr[t])
                            if p_sigma:
                                # Composition of ~|kf-t| odometry steps:
                                # variance grows linearly with hop count.
                                hops = max(abs(kf_id - t), 1)
                                prior_w = 1.0 / (p_sigma * p_sigma * hops)
                        else:
                            # Distant re-visit (or no odometry anchor): seed
                            # from the throttled optimized global estimate.
                            g_new = _global_est_new()
                            g_t = _global_est(t)
                            if g_new is not None and g_t is not None:
                                init = _seed_from(g_new, g_t)
                            else:
                                init = self.np_group.identity()
                        sigma = 0.0
                        if which == "closure" \
                                and self.parameters.closure_bootstrap:
                            # Measurement-based closure init: estimates at
                            # revisit time carry the loop's accumulated
                            # drift (engine/closure.py docstring).
                            from srba_tpu.engine.closure import \
                                bootstrap_closure_edge
                            if kf_id < self._closure_cooldown.get(t, 0):
                                continue   # recently hard-rejected: defer
                            pend = self._closure_pending.get(t)
                            if pend is not None and G_dr_new is not None \
                                    and pend["kf"] < len(self._G_dr):
                                # The cached weak fit is the best available
                                # seed: compose it forward by the (tiny,
                                # few-frame) dead-reckoned delta — the
                                # multi-start PnP then converges from its
                                # first start.
                                init = np.asarray(self.np_group.compose(
                                    _seed_from(G_dr_new,
                                               self._G_dr[pend["kf"]]),
                                    pend["T"]), np.float32)
                            with prof.scope("closure_bootstrap"):
                                voters = self._closure_voters(
                                    observations, t)
                                if voters and not synced_for_boot:
                                    # Retry fits run on every non-cooldown
                                    # closure-voting frame against a
                                    # loosely fresh mirror kept current by
                                    # the async prefetch cadence — a reject
                                    # on slightly stale data just re-votes
                                    # next frame, so no blocking sync is
                                    # spent here.
                                    self.sync(max_age=self.parameters
                                              .closure_mirror_max_age)
                                    synced_for_boot = True
                                status, T, ratio, sigma, fit_info = \
                                    bootstrap_closure_edge(
                                        self, t, voters, init)
                                if self.device_master is not None \
                                        and self.device_master.dirty \
                                        and status != "n/a" \
                                        and ratio <= self.parameters.\
                                        closure_reverify_band:
                                    # Passing-or-near fit on a possibly-
                                    # stale mirror: settle against the
                                    # exact device state (one blocking
                                    # sync) — fresh voter positions flip
                                    # marginal outcomes in BOTH directions
                                    # (a near-reject often becomes a
                                    # strong accept), so accepts, weaks
                                    # and near rejects all re-verify
                                    # (SrbaParams.closure_reverify_band);
                                    # far rejects cost nothing.
                                    self.sync()
                                    status, T, ratio, sigma, fit_info = \
                                        bootstrap_closure_edge(
                                            self, t, voters, init)
                            if status == "ok":
                                init = np.asarray(T, np.float32)
                                # Measured-covariance weighting: the fit's
                                # own sigma (floored at the odometry-grade
                                # edge_prior_sigma) sets the prior weight —
                                # strong closures anchor like odometry,
                                # weak ones inform proportionally.
                                sigma = max(float(sigma),
                                            self.parameters.edge_prior_sigma
                                            or 0.05)
                                if p_sigma:
                                    prior_w = 1.0 / (sigma * sigma)
                                self._closure_pending.pop(t, None)
                            elif status == "weak":
                                # Cache the best weak fit; materialize only
                                # if no strong fit arrives (flush below).
                                if pend is None or sigma < pend["sigma"]:
                                    self._closure_pending[t] = {
                                        "sigma": float(sigma),
                                        "T": np.asarray(T, np.float32),
                                        "info": fit_info,
                                        "kf": kf_id,
                                        "first_kf": (pend or
                                                     {}).get("first_kf",
                                                             kf_id)}
                                continue      # defer edge creation
                            elif status == "reject":
                                self._closure_cooldown[t] = (
                                    kf_id
                                    + self.parameters.closure_retry_cooldown)
                                continue      # defer: ECP re-votes later
                            else:
                                sigma = 0.0   # n/a: estimate-based seed
                        e = self._add_edge(kf_id, t, init, prior_w=prior_w,
                                           sigma=sigma, info=fit_info)
                        self.graph.add_edge(kf_id, t)
                        info.created_edge_ids.append(e)
                        if which == "closure":
                            closure_created = True
                            # An edge to this center now exists (any
                            # status): a pending weak fit must not flush a
                            # duplicate later.
                            self._closure_pending.pop(t, None)

                # Flush aged-out pending weak closures: no strong fit
                # arrived within the flush window, so the best weak fit
                # becomes the edge — valued at its own fit (relative to the
                # center, drift-free) and weighted by its measured sigma.
                # Edge endpoints are (kf_at_fit, center); the graph is
                # append-only, so inserting an edge at a slightly older
                # keyframe is always valid.
                if self._closure_pending:
                    flush_age = self.parameters.closure_pending_flush_age
                    for c in [c for c, r in self._closure_pending.items()
                              if kf_id - r["first_kf"] >= flush_age]:
                        rec = self._closure_pending.pop(c)
                        sig = max(rec["sigma"],
                                  self.parameters.edge_prior_sigma or 0.05)
                        e = self._add_edge(
                            rec["kf"], c, rec["T"],
                            prior_w=(1.0 / (sig * sig) if p_sigma else 0.0),
                            sigma=sig, info=rec.get("info"))
                        self.graph.add_edge(rec["kf"], c)
                        info.created_edge_ids.append(e)
                        closure_created = True

                # Record the new KF's dead-reckoned global pose: prefer the
                # odometry anchor; else derive from the first created edge.
                if G_dr_new is None and info.created_edge_ids:
                    e0 = info.created_edge_ids[0]
                    t0 = int(self.state.k2k_to[e0])
                    if t0 < len(self._G_dr):
                        G_dr_new = self.np_group.compose(
                            self._G_dr[t0],
                            self.np_group.inverse(self.state.k2k_pose[e0]))
                self._G_dr.append(
                    G_dr_new if G_dr_new is not None
                    else np.asarray(self.np_group.identity(), np.float32))

                if getattr(self.model, "is_pose_landmark", False):
                    # Graph-SLAM mode: observing a KF that is unreachable
                    # within the tree depth IS a loop closure — create the
                    # kf2kf edge, initialized from the measured relative
                    # pose itself (reference: relative-pose observations in
                    # graph-SLAM instantiations create edges to re-observed
                    # keyframes).
                    for o in observations:
                        j = o.lm_id
                        assert 0 <= j < kf_id, (
                            "graph-SLAM observations must reference existing "
                            f"keyframes; got {j} at kf {kf_id}")
                        if self.graph.path(
                                kf_id, j,
                                self.parameters.max_tree_depth) is None:
                            e = self._add_edge(
                                kf_id, j, np.asarray(o.z, np.float32))
                            self.graph.add_edge(kf_id, j)
                            info.created_edge_ids.append(e)

            with prof.scope("ingest"):
                # Batch the inverse-sensor-model landmark inits: one device
                # call per keyframe instead of one per new landmark (device
                # dispatch latency dominates the tiny math).
                inits = self._batch_landmark_inits(observations)
                for i, o in enumerate(observations):
                    self.add_observation(
                        kf_id, o.lm_id, o.z,
                        fixed_rel_pos=o.fixed_rel_pos,
                        init_rel_pos=inits.get(i, o.init_rel_pos),
                    )

            if run_local_optimization and kf_id > 0:
                with prof.scope("optimize_local_area"):
                    # A fresh closure edge is refined at the FULL tree depth
                    # (not the routine optimize depth): the deeper window
                    # reaches the revisited area's landmarks on both sides
                    # of the closure, so the bootstrap seed becomes a
                    # measurement-refined edge immediately.
                    depth = self.parameters.max_optimize_depth
                    if closure_created:
                        depth = max(depth, self.parameters.max_tree_depth)
                    # Closure-ACTIVE frames (an edge was created OR the ECP
                    # voted one, even if the fit deferred/weak-cached) run
                    # the full budget: a deferred fit that materializes via
                    # flush_pending_closures must not find its surrounding
                    # window only ever polished at the capped budget.
                    closure_active = closure_created or bool(closure_targets)
                    info.optimize_results = self.optimize_local_area(
                        kf_id, depth,
                        _iters_cap=(0 if closure_active else
                                    self.parameters.incremental_max_iters))
            elif self.device_master is not None:
                # No solve this frame: still push staged rows to the device
                # masters so they stay authoritative.
                self.device_master.flush_append()

            if self.device_master is not None:
                if closure_created:
                    # The refinement step just dispatched moved the map
                    # wholesale: raise the staleness barrier and ship a
                    # fresh post-closure prefetch immediately.
                    self._closure_barrier_seq = self.device_master.step_seq
                    self.device_master.maybe_prefetch(
                        self.parameters.closure_mirror_max_age, force=True)
                else:
                    # Steady async prefetch cadence (internally throttled to
                    # every max_age/2 steps; starting a copy costs ~0.35 ms):
                    # every stale-tolerant consumer — the closure bootstrap
                    # AND the every-25-KF closure-seed spanning-tree rebuild
                    # — consumes an already-landed copy instead of a
                    # blocking fetch that must first drain the async solve
                    # queue (measured 220 ms/rebuild on config#3, 51% of
                    # the per-KF budget, before this cadence existed).
                    self.device_master.maybe_prefetch(
                        self.parameters.closure_mirror_max_age)
        if self.parameters.verbose >= 1:
            print(f"[srba] kf={kf_id} edges+={len(info.created_edge_ids)} "
                  f"opt={info.optimize_results}")
        return info

    def flush_pending_closures(self) -> int:
        """Materialize every still-pending weak closure fit immediately
        (normally they flush after ``closure_pending_flush_age`` keyframes;
        call this before a terminal global refinement so fits cached near
        the end of a sequence are not lost).  Returns the number of edges
        created.  ``refine_map`` and ``optimize_global`` call it
        implicitly."""
        n = 0
        p_sigma = self.parameters.edge_prior_sigma
        for c in list(self._closure_pending):
            rec = self._closure_pending.pop(c)
            sig = max(rec["sigma"], self.parameters.edge_prior_sigma or 0.05)
            self._add_edge(rec["kf"], c,  rec["T"],
                           prior_w=(1.0 / (sig * sig) if p_sigma else 0.0),
                           sigma=sig, info=rec.get("info"))
            self.graph.add_edge(rec["kf"], c)
            n += 1
        return n

    def _closure_voters(self, observations, center: int):
        """Re-observed landmarks usable to bootstrap a closure edge to
        ``center``: known landmarks whose base KF is reachable from the
        center within the tree depth."""
        out = []
        depth = self.parameters.max_tree_depth
        for o in observations:
            lm = self._lm_id_map.get(o.lm_id)
            if lm is None:
                continue
            base = int(self.state.lm_base[lm])
            if base == center or self.graph.path(
                    center, base, depth) is not None:
                out.append((lm, np.asarray(o.z, np.float32)))
        return out

    def add_observation(self, kf_id: int, lm_id: int, z,
                        fixed_rel_pos=None, init_rel_pos=None) -> int:
        """Register one observation; first sighting of a landmark makes
        ``kf_id`` its base KF and initializes its relative state (reference
        ``add_observation`` + ``inverse_sensor_model``).

        Returns the observation id, or **-1** when the landmark is monocular
        with no init and the deferred-triangulation front-end is active: the
        sighting is buffered (``num_pending_landmarks``) and replayed once
        the landmark triangulates — the -1 sentinel means "accepted but not
        yet part of the problem"."""
        z = np.asarray(z, np.float32)
        assert z.shape == (self.model.z_dim,), (
            f"observation must be {self.model.z_dim}-d, got {z.shape}")
        internal = self._lm_id_map.get(lm_id)
        if internal is None and getattr(self.model, "is_pose_landmark",
                                        False):
            # Graph-SLAM mode: the 'landmark' for keyframe j is the IDENTITY
            # pose fixed at base j itself, so every observation of j
            # constrains the spanning-tree path of kf2kf edges between
            # observer and j (the problem degenerates to a relative
            # pose-graph; SURVEY.md §1.1).
            internal = self._add_landmark(
                lm_id, np.asarray(self.np_group.identity(), np.float32),
                fixed=True)
            self._lm_id_map[lm_id] = internal
        if internal is None:
            # New landmark: allocate with base = observing KF.
            if fixed_rel_pos is not None:
                st = np.asarray(fixed_rel_pos, np.float32)
                internal = self._add_landmark(kf_id, st, fixed=True)
            elif (init_rel_pos is None and not self.model.has_inverse_model
                  and self.parameters.mono_min_parallax_deg is not None):
                # Monocular deferred init: buffer the sighting; materialize
                # by two-view triangulation once parallax suffices.
                tri = self._triangulator()
                tri.hold(lm_id, kf_id, z)
                hit = tri.try_init(lm_id)
                if hit is None:
                    return -1          # still pending
                base_kf, pt, buffered = hit
                internal = self._add_landmark(base_kf, pt, fixed=False)
                self._lm_id_map[lm_id] = internal
                oid = -1
                for kf_b, z_b in buffered:   # replay (incl. this sighting)
                    if self.native is not None:
                        self.native.add_observation(kf_b, internal)
                    oid = self.state.add_observation(kf_b, internal, z_b)
                return oid
            else:
                st = self._init_landmark(z, init_rel_pos)
                internal = self._add_landmark(kf_id, st, fixed=False)
            self._lm_id_map[lm_id] = internal
        if self.native is not None:
            self.native.add_observation(kf_id, internal)
        return self.state.add_observation(kf_id, internal, z)

    def _batch_landmark_inits(self, observations) -> Dict[int, np.ndarray]:
        """Inverse-sensor-model inits for this frame's brand-new landmarks,
        computed in one batched call.  Returns {obs_list_index: init}."""
        if not self.model.has_inverse_model:
            return {}
        idxs, seen = [], set()
        for i, o in enumerate(observations):
            if (o.lm_id in self._lm_id_map or o.lm_id in seen
                    or o.fixed_rel_pos is not None
                    or o.init_rel_pos is not None):
                continue
            seen.add(o.lm_id)
            idxs.append(i)
        if not idxs:
            return {}
        zs = np.stack([np.asarray(observations[i].z, np.float32)
                       for i in idxs])
        # Numpy-in -> numpy-out inverse model (host path, no device hop).
        pts = np.asarray(self.model.inverse(zs, self._calib_np), np.float32)
        if self._use_sensor_pose and not getattr(
                self.model, "is_pose_landmark", False):
            pts = self.np_group.apply(self._sensor_pose, pts)
        return {i: pts[j] for j, i in enumerate(idxs)}

    def _triangulator(self):
        if self._tri is None:
            from srba_tpu.engine.triangulate import MonoTriangulator
            self._tri = MonoTriangulator(
                self, min_parallax_deg=self.parameters.mono_min_parallax_deg)
        return self._tri

    def _init_landmark(self, z: np.ndarray, init_rel_pos) -> np.ndarray:
        if init_rel_pos is not None:
            return np.asarray(init_rel_pos, np.float32)
        if not self.model.has_inverse_model:
            raise ValueError(
                f"{self.model.name} has no single-view inverse sensor model; "
                "pass init_rel_pos (or fixed_rel_pos) for new landmarks, or "
                "enable the deferred-triangulation front-end "
                "(SrbaParams.mono_min_parallax_deg)")
        # Inverse model gives the landmark in the SENSOR frame; map into the
        # base-KF (robot) frame through the mounting pose.  Host-side numpy
        # for the tiny per-landmark math (see np_lie docstring).
        pt = np.asarray(self.model.inverse(z, self._calib_np), np.float32)
        if getattr(self.model, "is_pose_landmark", False):
            return pt
        if self._use_sensor_pose:
            pt = self.np_group.apply(self._sensor_pose, pt)
        return pt.astype(np.float32)

    # ------------------------------------------------------------------
    # Optimization
    # ------------------------------------------------------------------

    def optimize_local_area(self, root_kf: int,
                            win_size: Optional[int] = None,
                            restrict_edges=None, restrict_lms=None,
                            _iters_cap: int = 0) -> Dict[str, float]:
        """BFS window around ``root_kf`` -> padded batch -> jitted LM+Schur
        -> write back (reference ``optimize_local_area``).  With
        ``restrict_edges`` / ``restrict_lms`` (sets of global ids) the
        unknowns are limited to those lists (used by ``optimize_edges``)."""
        import jax
        import jax.numpy as jnp

        depth = (win_size if win_size is not None
                 else self.parameters.max_optimize_depth)
        master = self.device_master
        with self.profiler.scope("window_build"):
            cap = self.parameters.extra_obs_per_lm_cap
            if master is not None and self.native is not None:
                built = self.native.build_window(
                    self.state, root_kf, depth,
                    self.parameters.max_tree_depth, obs_per_lm_cap=cap)
            else:
                built = build_window(
                    self.state, self.graph, root_kf, depth,
                    self.parameters.max_tree_depth,
                    extra_obs_per_lm_cap=cap,
                    gather_floats=master is None)
        if built is None:
            if master is not None:
                master.flush_append()
            return {"skipped": 1.0}
        arrays, plan = built

        if restrict_edges is not None:
            keep = np.asarray([g in restrict_edges for g in arrays.edge_gids],
                              np.float32)
            arrays.edge_opt[:] = arrays.edge_opt * keep
            plan.edge_opt[:] = plan.edge_opt & np.asarray(
                [g in restrict_edges for g in plan.edge_ids])
        if restrict_lms is not None:
            keepl = np.asarray([g in restrict_lms for g in arrays.lm_gids],
                               np.float32)
            arrays.lm_opt[:] = arrays.lm_opt * keepl[: len(arrays.lm_opt)]
            plan.lm_opt[:] = plan.lm_opt & np.asarray(
                [g in restrict_lms for g in plan.lm_ids])

        if master is not None:
            # Device-master fast path (M3): append staged rows + gather +
            # LM+Schur + scatter-back in ONE async dispatch; nothing is
            # downloaded (info values are fetched lazily on first access).
            with self.profiler.scope("device_step"):
                return master.step(
                    self._solver_cfg, self._whitener, self._sensor_pose_inv,
                    self.calib,
                    arrays.edge_gids, arrays.edge_opt, arrays.lm_gids,
                    arrays.lm_opt, arrays.obs_lm, arrays.obs_valid,
                    arrays.path_edge, arrays.path_sign, arrays.obs_z,
                    iters_cap=_iters_cap)

        with self.profiler.scope("device_solve"):
            # Runtime LM iteration cap (same semantics as the device-master
            # path: 0 = full budget).  A scalar leaf, so capped vs uncapped
            # are two jit specializations per backend — each engine mode
            # settles into one steady shape after warmup.
            cap = (np.asarray(_iters_cap, np.int32)
                   if _iters_cap > 0 else None)
            if self.mesh is not None:
                # SPMD path: keep every leaf an UNCOMMITTED host array
                # (numpy) — in multi-process runs JAX places per-device
                # shards from each process's identical full copy; a
                # committed single-device jnp array would be rejected.
                from srba_tpu.parallel.sharding import make_spmd_solver
                batch = WindowBatch(
                    edge_pose=arrays.edge_pose, edge_opt=arrays.edge_opt,
                    lm_state=arrays.lm_state, lm_opt=arrays.lm_opt,
                    obs_z=arrays.obs_z, obs_lm=arrays.obs_lm,
                    path_edge=arrays.path_edge,
                    path_sign=arrays.path_sign.astype(np.float32),
                    obs_valid=arrays.obs_valid,
                    whitener=self._whitener,
                    sensor_pose_inv=self._sensor_pose_inv,
                    calib=self._calib_np,
                    edge_prior=arrays.edge_prior,
                    edge_prior_w=arrays.edge_prior_w,
                    iters_cap=cap,
                )
                solve, _ = make_spmd_solver(self._solver_cfg, self.mesh)
            else:
                batch = WindowBatch(
                    edge_pose=jnp.asarray(arrays.edge_pose),
                    edge_opt=jnp.asarray(arrays.edge_opt),
                    lm_state=jnp.asarray(arrays.lm_state),
                    lm_opt=jnp.asarray(arrays.lm_opt),
                    obs_z=jnp.asarray(arrays.obs_z),
                    obs_lm=jnp.asarray(arrays.obs_lm),
                    path_edge=jnp.asarray(arrays.path_edge),
                    path_sign=jnp.asarray(arrays.path_sign),
                    obs_valid=jnp.asarray(arrays.obs_valid),
                    whitener=jnp.asarray(self._whitener),
                    sensor_pose_inv=jnp.asarray(self._sensor_pose_inv),
                    calib=self.calib,
                    edge_prior=jnp.asarray(arrays.edge_prior),
                    edge_prior_w=jnp.asarray(arrays.edge_prior_w),
                    iters_cap=(None if cap is None else jnp.asarray(cap)),
                )
                solve, _ = get_solver(self._solver_cfg)
            edge_pose, lm_state, dev_info = solve(batch)
            # One batched download of the whole result tuple.
            edge_pose, lm_state, dev_info = jax.device_get(
                (edge_pose, lm_state, dev_info))

        with self.profiler.scope("write_back"):
            write_back(self.state, plan, edge_pose, lm_state)

        return {k: float(v) for k, v in dev_info.items()}

    def optimize_edges(self, k2k_edge_ids: Sequence[int],
                       landmark_ids: Optional[Sequence[int]] = None
                       ) -> Dict[str, float]:
        """Explicit-list variant (reference ``optimize_edges``): optimize
        EXACTLY the given edges (and landmarks, if listed — else every
        in-window non-fixed landmark), using the observations of the window
        rooted at the newest keyframe touching the edge set."""
        if not k2k_edge_ids:
            return {"skipped": 1.0}
        root = max(max(int(self.state.k2k_from[e]), int(self.state.k2k_to[e]))
                   for e in k2k_edge_ids)
        return self.optimize_local_area(
            root, self.parameters.max_optimize_depth,
            restrict_edges=set(int(e) for e in k2k_edge_ids),
            restrict_lms=(None if landmark_ids is None
                          else set(int(l) for l in landmark_ids)))

    # ------------------------------------------------------------------
    # Global-map recovery & evaluation
    # ------------------------------------------------------------------

    def create_complete_spanning_tree(self, root: int = 0,
                                      _mirror_max_age: int = 0):
        """Global KF poses by composing relative edge poses outward from
        ``root`` over the full BFS tree (reference
        ``create_complete_spanning_tree`` / ``bfs_visitor``; global poses are
        derived products, never state — SURVEY.md §1.3).  Composition is
        vectorized per BFS level (O(depth) batched group ops, not O(K)
        scalar composes — matters at multi-thousand-KF maps).

        ``_mirror_max_age`` is internal (closure seed cache): public callers
        always get an exact, current-state tree."""
        with self.profiler.scope("spantree_sync"):
            self.sync(max_age=_mirror_max_age)
        with self.profiler.scope("spantree_bfs"):
            dist, parent = self.graph.complete_spanning_tree(root)
        G = np.zeros((self.state.num_kfs, self.group.dim), np.float32)
        G[root] = self.np_group.identity()
        # Group nodes by BFS depth, then batch-compose level by level.
        with self.profiler.scope("spantree_compose"):
            by_level: Dict[int, List[int]] = {}
            for n, d in dist.items():
                if n != root:
                    by_level.setdefault(d, []).append(n)
            for d in sorted(by_level):
                nodes = np.asarray(by_level[d], np.int32)
                ps = np.asarray([parent[int(n)][0] for n in nodes], np.int32)
                eids = np.asarray([parent[int(n)][1] for n in nodes],
                                  np.int32)
                ea = self.state.k2k_from[eids]
                steps = self.state.k2k_pose[eids].copy()
                rev = ea != ps    # edge stored (a,b): reversed when a != p
                if rev.any():
                    steps[rev] = self.np_group.inverse(steps[rev])
                G[nodes] = self.np_group.compose(G[ps],
                                                 steps).astype(np.float32)
        return G, dist

    def bfs_visitor(self, root: int, max_depth: int, kf_visitor=None,
                    k2k_visitor=None, lm_visitor=None, k2f_visitor=None):
        """Generic BFS traversal with callbacks — the four-visitor analog of
        the reference's ``bfs_visitor<KF_VISITOR, FEAT_VISITOR, K2K_VISITOR,
        K2F_VISITOR>``:

        * ``kf_visitor(kf_id, depth)`` per reached keyframe;
        * ``k2k_visitor(edge_id, parent_kf, child_kf)`` per tree edge;
        * ``lm_visitor(lm_id, base_kf, depth)`` per landmark whose base KF
          is reached (once, at the base's depth — the FEAT visitor);
        * ``k2f_visitor(obs_id, kf_id, lm_id)`` per observation made from a
          reached keyframe.
        """
        dist, parent = self.graph.bfs_tree(root, max_depth)
        order = sorted(dist.keys(), key=lambda n: (dist[n], n))
        by_base: Dict[int, List[int]] = {}
        if lm_visitor is not None:
            for lm in range(self.state.num_lms):
                by_base.setdefault(int(self.state.lm_base[lm]),
                                   []).append(lm)
        for n in order:
            if kf_visitor is not None:
                kf_visitor(n, dist[n])
            if n != root and k2k_visitor is not None:
                p, eid = parent[n]
                k2k_visitor(eid, p, n)
            if k2f_visitor is not None:
                for o in self.state.kf_obs[n]:
                    k2f_visitor(o, n, int(self.state.obs_lm[o]))
            if lm_visitor is not None:
                for lm in by_base.get(n, ()):
                    lm_visitor(lm, n, dist[n])
        return dist

    def refine_map(self, sweeps: int = 1, stride: Optional[int] = None,
                   depth: Optional[int] = None, mesh=None,
                   prior_scale: float = 0.02) -> Dict[str, float]:
        """Map-parallel refinement (M4): block-coordinate LM sweeps over the
        whole map — windows around every ``stride``-th keyframe are solved
        SIMULTANEOUSLY in one vmapped device dispatch per sweep, each unknown
        owned by exactly one window per sweep (disjoint writes; see
        :mod:`srba_tpu.solver.multi_window`).  With ``mesh`` the window axis
        is sharded over devices.  Requires the device-master path.

        ``prior_scale`` scales the edge measurement priors inside sweep
        windows; the default **0.02** is a measured sweet spot on the
        8-device dryrun problem (final map error: priors at full weight
        4.54 — they anchor every window to its creation-time dead-reckoned
        value, stale by exactly the drift the sweep should remove; priors
        OFF 3.41 — block-coordinate sweeps oscillate along weakly-observed
        directions; priors at 2% 0.26 — enough Tikhonov-style
        regularization to damp the oscillation without the anchor bias).
        Sweep windows lacking observation support leave their unknowns
        essentially unmoved (tiny prior pull + masked diagonal)."""
        import jax.numpy as jnp

        from srba_tpu.solver.multi_window import (make_sweep_step,
                                                  make_sweep_step_mesh,
                                                  plan_sweep_roots)
        from srba_tpu.solver.master import pack_window_ints

        assert self.device_master is not None, \
            "refine_map requires the device-master engine mode"
        self.flush_pending_closures()
        dm = self.device_master
        dm.flush_append()
        tree_depth = self.parameters.max_tree_depth
        depth = depth or self.parameters.max_optimize_depth
        step = (make_sweep_step(self._solver_cfg) if mesh is None
                else make_sweep_step_mesh(self._solver_cfg, mesh))
        if dm._whitener_dev is None:
            import jax
            dm._whitener_dev = jnp.asarray(self._whitener, jnp.float32)
            dm._spinv_dev = jnp.asarray(self._sensor_pose_inv, jnp.float32)
            dm._calib_dev = jax.tree.map(jnp.asarray, self.calib)
        info_out: Dict[str, float] = {"windows": 0.0}
        dev_info = None

        if stride is None:
            stride = getattr(self.ecp, "submap_size", None) \
                or self.parameters.max_optimize_depth
        stride = max(1, int(stride))
        for si in range(max(1, int(sweeps)) * 2):
            # Stagger the root lattice between FULL sweeps (offset shifts by
            # half a stride every other sweep) so window boundaries move and
            # boundary unknowns get interior treatment in alternate sweeps;
            # within a sweep, red-black phases keep adjacent windows from
            # updating simultaneously (Jacobi overshoot): each phase's
            # windows are far apart (fully parallel) while neighbors update
            # sequentially (Gauss-Seidel).
            offset = ((si // 2) % 2) * (stride // 2)
            all_roots = plan_sweep_roots(self, stride, offset=offset)
            roots = [all_roots[0::2], all_roots[1::2]][si % 2]
            wins = []
            claimed_e: set = set()
            claimed_l: set = set()
            cap = self.parameters.extra_obs_per_lm_cap
            for root in roots:
                if self.native is not None:
                    built = self.native.build_window(
                        self.state, root, depth, tree_depth,
                        obs_per_lm_cap=cap)
                else:
                    built = build_window(self.state, self.graph, root, depth,
                                         tree_depth, extra_obs_per_lm_cap=cap,
                                         gather_floats=False)
                if built is None:
                    continue
                arrays, plan = built
                # Ownership: zero the opt mask on already-claimed unknowns
                # (vectorized; pad slots have opt == 0 already).
                e_claimed = np.isin(
                    arrays.edge_gids,
                    np.fromiter(claimed_e, np.int32, len(claimed_e)))
                l_claimed = np.isin(
                    arrays.lm_gids,
                    np.fromiter(claimed_l, np.int32, len(claimed_l)))
                e_own = (arrays.edge_opt > 0) & ~e_claimed
                l_own = (arrays.lm_opt > 0) & ~l_claimed
                if not (e_own.any() or l_own.any()):
                    continue
                claimed_e.update(arrays.edge_gids[e_own].tolist())
                claimed_l.update(arrays.lm_gids[l_own].tolist())
                e_own = e_own.astype(np.float32)
                l_own = l_own.astype(np.float32)
                wins.append((arrays, e_own, l_own))
            if not wins:
                continue  # this parity phase is empty; others may not be

            # Common bucket shape + stacking.
            E = max(a.edge_gids.shape[0] for a, _, _ in wins)
            L = max(a.lm_gids.shape[0] for a, _, _ in wins)
            N = max(a.obs_z.shape[0] for a, _, _ in wins)
            W = len(wins)
            if mesh is not None:
                n_dev = int(np.prod(list(mesh.shape.values())))
                W = ((W + n_dev - 1) // n_dev) * n_dev
            D = tree_depth
            T = 2 * E + 2 * L + 2 * N + 2 * N * D
            ints = np.zeros((W, T), np.int32)
            obs_z = np.zeros((W, N, self.state.z_dim), np.float32)

            def pad_to(a, n, fill=0):
                out = np.full((n,) + a.shape[1:], fill, a.dtype)
                out[: a.shape[0]] = a
                return out

            for wi, (a, e_own, l_own) in enumerate(wins):
                ints[wi] = pack_window_ints(
                    pad_to(a.edge_gids, E), pad_to(e_own, E),
                    pad_to(a.lm_gids, L), pad_to(l_own, L),
                    pad_to(a.obs_lm, N), pad_to(a.obs_valid, N),
                    pad_to(a.path_edge, N), pad_to(a.path_sign, N))
                obs_z[wi, : a.obs_z.shape[0]] = a.obs_z
                if a.obs_z.shape[0] < N:   # valid-valued padding rows
                    obs_z[wi, a.obs_z.shape[0]:] = a.obs_z[0]
            # Padding windows (mesh divisibility): all-zero opt masks; point
            # their obs at window 0's values to stay non-degenerate.
            for wi in range(len(wins), W):
                ints[wi] = ints[0] * 0
                obs_z[wi] = obs_z[0]

            # Scale (default: zero) the prior WEIGHT column for the sweep;
            # dm.prior itself is untouched (functional .at update), so the
            # incremental path keeps its priors.
            prior_in = (dm.prior if prior_scale == 1.0 else
                        dm.prior.at[:, self.group.dim].multiply(
                            float(prior_scale)))
            dm.pose, dm.lm, dev_info = step(
                dm.pose, prior_in, dm.lm, jnp.asarray(ints),
                jnp.asarray(obs_z),
                dm._whitener_dev, dm._spinv_dev, dm._calib_dev, E, L, N)
            dm.dirty = True
            info_out["windows"] += float(len(wins))
        self._seed_cache = None   # sweep moved poses wholesale
        self._closure_barrier_seq = dm.step_seq
        if dev_info is not None:
            import jax
            info_out.update({k: float(v) for k, v in
                             jax.device_get(dev_info).items()})
        return info_out

    def optimize_global(self, cfg=None, write_back: bool = True, mesh=None,
                        periodic: bool = False, use_edge_info: bool = False):
        """Global pose-graph optimization over ALL kf2kf edges — the
        in-framework replacement for the reference's export-to-MRPT-graphslam
        path (``get_global_graphslam_problem`` consumed by an external
        optimizer; here it is consumed by the matrix-free LM-PCG of
        :mod:`srba_tpu.solver.global_graphslam`).

        ``periodic`` marks a MID-RUN refinement (a growing map re-optimized
        every N keyframes): certification switches to a scale-free
        diminishing-returns stop (``rel_tol`` 1e-3 — the robust IRLS
        re-weighting gives warm maps a geometric improvement tail that
        stays above the terminal 1e-5 tolerance for 60+ iterations while
        the iterate has long stopped moving; measured round 4, config#5's
        KF-2500/3750 refinements burned the full budget + escalation and
        exited uncertified) and the LM damping warm-starts from the
        previous periodic solve's final lambda (a runtime operand — no
        recompile).  Terminal calls keep the strict tolerance.

        ``use_edge_info`` feeds the closure fits' ANISOTROPIC information
        shapes into the solve (``io/export.py``).  Off by default on an
        A/B of ATE (config#3 stereo terminal PGO: shaped 0.235 ATE
        uncertified vs scalar 0.193 certified — loops need closures
        enforced in the fit's weak directions too);
        the g2o export always carries the full matrices for external
        consumers.

        Returns ``(G_opt [K, pose_dim], info)``.  With ``write_back`` the
        relative edge poses are re-derived from the optimized globals
        (``T_a<-b = inv(G_a) ∘ G_b``) so subsequent incremental operation
        continues from the globally consistent map."""
        import dataclasses as _dc

        from srba_tpu.io.export import get_global_graphslam_problem
        from srba_tpu.solver.global_graphslam import \
            optimize_global_pose_graph

        if mesh is None:
            mesh = self.mesh
        self.flush_pending_closures()
        if self.device_master is not None:
            self.device_master.flush_append()
        prob = get_global_graphslam_problem(
            self, with_edge_info=use_edge_info)  # syncs internally
        if cfg is None:
            from srba_tpu.solver.global_graphslam import PGOConfig
            # Engine callers get the basin-robust path by default: chordal
            # initialization handles arbitrary accumulated orientation drift
            # (solver/chordal.py) before the local LM-PCG refinement, a
            # pseudo-Huber edge loss caps the pull of any single biased
            # closure, and per-edge observation-support weights (exported in
            # the problem dict) mirror the reference's per-edge information
            # matrices.
            cfg = PGOConfig(group=self.group.name, chordal_init=True,
                            robust_delta=0.1)
        lam0 = None
        if periodic:
            cfg = _dc.replace(cfg, rel_tol=1e-3)
            lam0 = getattr(self, "_pgo_warm_lam", None)
        G_opt, info = optimize_global_pose_graph(prob, cfg, mesh=mesh,
                                                 lam0=lam0)
        if periodic:
            self._pgo_warm_lam = float(info.get("lam", cfg.lam0))
        if write_back and self.state.num_edges:
            a = self.state.k2k_from[: self.state.num_edges]
            b = self.state.k2k_to[: self.state.num_edges]
            self.state.k2k_pose[: self.state.num_edges] = \
                self.np_group.compose(self.np_group.inverse(G_opt[a]),
                                      G_opt[b]).astype(np.float32)
            if self.device_master is not None:
                self.device_master.upload_from_host(
                    self.state.k2k_pose, self.state.lm_state,
                    self.state.num_edges, self.state.num_lms,
                    k2k_prior=self.state.k2k_prior,
                    k2k_prior_w=self.state.k2k_prior_w)
            self._G_dr = [np.asarray(G_opt[k], np.float32)
                          for k in range(self.state.num_kfs)]
            self._seed_cache = None   # poses changed wholesale
        return G_opt, info

    def eval_overall_squared_error(self) -> float:
        """Total whitened squared error over ALL observations, using
        global poses composed from the complete spanning tree (reference
        ``eval_overall_squared_error``)."""
        if self.state.num_obs == 0:
            return 0.0
        self.sync()
        import jax
        import jax.numpy as jnp

        G, dist = self.create_complete_spanning_tree(0)
        nobs = self.state.num_obs
        obs_kf = self.state.obs_kf[:nobs]
        obs_lm = self.state.obs_lm[:nobs]
        reachable = np.asarray([int(k) in dist for k in obs_kf])
        # T_obs<-base = inv(G_obs) o G_base  (host compose, vectorized numpy)
        T = self.np_group.compose(
            self.np_group.inverse(G[obs_kf]),
            G[self.state.lm_base[obs_lm]],
        ).astype(np.float32)
        lm = self.state.lm_state[obs_lm]
        z = self.state.obs_z[:nobs]
        valid = reachable.astype(np.float32)

        if self._eval_fn is None:
            group, model, cfg = self.group, self.model, self._solver_cfg

            @jax.jit
            def _eval(T, lm, z, valid, whitener, sensor_pose_inv, calib):
                if getattr(model, "is_pose_landmark", False):
                    pred = group.compose(T, lm)
                else:
                    pt = group.apply(T, lm)
                    if cfg.use_sensor_pose:
                        pt = group.apply(sensor_pose_inv, pt)
                    pred = model.h(pt, calib)
                r = model.residual(pred, z) @ whitener.T
                return jnp.sum(jnp.sum(r * r, axis=-1) * valid)

            self._eval_fn = _eval
        out = self._eval_fn(
            jnp.asarray(T), jnp.asarray(lm), jnp.asarray(z),
            jnp.asarray(valid), jnp.asarray(self._whitener),
            jnp.asarray(self._sensor_pose_inv), self.calib)
        return float(jax.device_get(out))

    def get_rba_state(self) -> ProblemState:
        """Read-only access to the SoA problem state (reference
        ``get_rba_state``).  Syncs the host mirror first."""
        self.sync()
        return self.state

    # Number shortcuts
    @property
    def num_keyframes(self) -> int:
        return self.state.num_kfs

    @property
    def num_landmarks(self) -> int:
        return self.state.num_lms

    @property
    def num_pending_landmarks(self) -> int:
        """Monocular landmarks buffered by the deferred-triangulation
        front-end, not yet materialized (see ``add_observation``)."""
        return 0 if self._tri is None else self._tri.num_pending
