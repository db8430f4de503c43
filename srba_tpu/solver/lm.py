"""Jitted Levenberg-Marquardt with Schur-complement landmark marginalization.

This is the batched-device rebuild of the reference solver stack (public MRPT/srba
layout; SURVEY.md §4.2): ``optimize_edges``'s LM outer loop
(``impl/lev-marq*``), the Jacobian engine (``impl/jacobians.h``), residuals
(``impl/reprojection_errors.h``), sparse-block Hessian assembly
(``srba_types.h`` block containers) and the Schur complement (``impl/schur.h``)
— fused into ONE jitted program per problem configuration.

Design (deliberately not a port):

* The reference walks pointer-linked symbolic structures per observation and
  evaluates hand-derived closed-form Jacobian blocks, then accumulates into
  map-of-block sparse matrices.  Here each observation is one lane of a
  ``vmap``: it gathers its (padded, <= depth-D) spanning-tree path of edge
  poses, composes them, and forward-mode AD at delta=0 yields the exact
  Jacobian wrt every path edge's tangent and the landmark — the closed-form
  chain rule, derived by the compiler, batched over all observations.
* Within a bounded window everything is DENSE: the pose Jacobian is
  scattered (one-hot einsum — a matmul, not an XLA scatter) into
  ``[N*od, E*pdof]`` and the reduced camera system is formed by plain
  matmuls; landmark blocks stay batched ``[L, ldof, ldof]`` and are inverted
  by the unrolled batched ``spd_inverse`` (``ops/block_linalg.py``).
  Sparsity across the *map* is delivered by the bounded window (the SRBA
  thesis), not by sparse matrix storage.  Whether the one-hot design still
  beats the segmented backend on the GPU is open (ROADMAP S2).
* The LM loop is a ``lax.while_loop`` over fixed-shape state: one device
  dispatch optimizes a whole keyframe's window.
* Masking convention: padded/fixed rows and columns carry weight 0; their
  normal-equation diagonal gets +1 so the system stays SPD and their deltas
  are exactly 0.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Optional

import jax
import jax.numpy as jnp

from srba_tpu.models.landmarks import LANDMARK_TYPES
from srba_tpu.models.observations import OBSERVATION_MODELS
from srba_tpu.ops.block_linalg import spd_inverse
from srba_tpu.ops.lie import GROUPS
from srba_tpu.ops.robust import pseudo_huber_cost, pseudo_huber_weight


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WindowBatch:
    """Padded, fixed-shape device view of one optimization window."""

    edge_pose: jnp.ndarray   # [E, pose_dim] involved kf2kf edge poses
    edge_opt: jnp.ndarray    # [E] 1.0 = unknown in this window, 0.0 = fixed/pad
    lm_state: jnp.ndarray    # [L, lm_dim]
    lm_opt: jnp.ndarray      # [L] 1.0 = unknown, 0.0 = fixed/pad
    obs_z: jnp.ndarray       # [N, z_dim]
    obs_lm: jnp.ndarray      # [N] int32 local landmark index
    path_edge: jnp.ndarray   # [N, D] int32 local edge index (0 on pad steps)
    path_sign: jnp.ndarray   # [N, D] +1 fwd / -1 rev / 0 pad
    obs_valid: jnp.ndarray   # [N] 1.0 = real observation
    whitener: jnp.ndarray    # [od, od] Lambda^{1/2} noise whitening
    sensor_pose_inv: jnp.ndarray  # [pose_dim] inverse sensor mounting pose
    calib: Any = None        # observation-model calibration pytree (or None)
    # Optional per-edge measurement priors (creation-time odometry / closure
    # bootstrap): residual sqrt(w) * plog(inv(prior) o edge) per opt edge.
    # None = no prior factors (structure-static: a batch either has them or
    # not, each choice is its own jit specialization).
    edge_prior: Any = None       # [E, pose_dim] or None
    edge_prior_w: Any = None     # [E] information weight (0 = no prior)
    # Optional RUNTIME iteration cap (scalar int32; None = cfg.max_iters).
    # Same compiled program serves both regimes: steady-state incremental
    # steps run a few iterations (windows overlap across keyframes, so the
    # next frames finish the polish — the iSAM-style argument), while
    # closure-refinement frames and explicit optimize_edges calls run the
    # full budget.  Measured on config#3 (stereo 500 KF): mean 15.2
    # iters/step uncapped with a third of steps hitting the 20-cap, equal
    # final ATE down to cap=3 — the surplus was pure device-queue backlog
    # (cap policy + per-config numbers: SrbaParams.incremental_max_iters).
    iters_cap: Any = None        # scalar int32 or None


@dataclass(frozen=True)
class SolverConfig:
    """Static (hashable) solver specialization — the analog of the
    reference's compile-time ``RBA_OPTIONS`` template bundle; each distinct
    config jit-compiles its own XLA program."""

    obs_model: str
    pose_group: str
    lm_type: str
    max_depth: int                 # D: padded spanning-tree path length
    # Solver engine — analog of the reference's three solver selectors
    # (``solver_LM_schur_dense_cholesky`` / ``..._schur_sparse_cholesky`` /
    # ``..._no_schur_sparse_cholesky``).  The window system is small and
    # bounded, so the two variants offered are Schur-marginalized vs
    # full-system DENSE Cholesky (a sparse Cholesky would strand the solve
    # on scalar pointer-chasing); the reference's sparse backends are
    # intentionally not replicated (design note in module docstring).
    solver: str = "schur_dense_cholesky"   # | "no_schur_dense_cholesky"
    use_sensor_pose: bool = False
    use_robust_kernel: bool = False
    kernel_param: float = 1.0
    max_iters: int = 20
    lam0: float = 1e-4
    lam_up: float = 10.0
    lam_down: float = 0.1
    lam_min: float = 1e-10
    lam_max: float = 1e8
    rel_tol: float = 1e-6
    diag_floor: float = 1e-8
    # Enough consecutive rejects for lambda to climb ~6 decades before
    # giving up — 3 was observed to strand hard loop-closure windows with
    # the step still too long (err frozen at init).
    max_consec_rejects: int = 6
    # Normal-equation reduction backend:
    # * "onehot" (default) — scatter the per-depth Jacobian blocks into a
    #   DENSE [N*od, E*pdof] window Jacobian with a one-hot contraction,
    #   then plain matmuls.  The dense intermediate costs N*od*E*pdof
    #   floats of device-memory traffic per iteration.
    # * "segmented" — batched per-depth-pair block products
    #   [N, D, D, pdof, pdof] + segment-sums keyed by the path-edge index
    #   pairs; never materializes the dense Jacobian (half the counted
    #   bytes, 1/5 the flops at E=256/N=16384), at the price of E^2-segment
    #   scatter-adds (atomics on the GPU).
    # Equivalence-tested (tests/test_solver_variants.py); which one is
    # faster on the GPU is not measured yet (ROADMAP S2/D3).
    neq: str = "onehot"
    # SPMD: name of the mesh axis observations are sharded over (psum of
    # partial normal equations rides this axis); None = single-device.
    axis_name: Optional[str] = None


VALID_SOLVERS = ("schur_dense_cholesky", "no_schur_dense_cholesky")
VALID_NEQ = ("onehot", "segmented")


def _resolve(cfg: SolverConfig):
    if cfg.solver not in VALID_SOLVERS:
        raise ValueError(
            f"unknown solver {cfg.solver!r}; available: {VALID_SOLVERS} "
            "(the reference's sparse-Cholesky engines are intentionally not "
            "replicated — see SolverConfig.solver)")
    if cfg.neq not in VALID_NEQ:
        raise ValueError(f"unknown neq backend {cfg.neq!r}; available: "
                         f"{VALID_NEQ}")
    return (GROUPS[cfg.pose_group], OBSERVATION_MODELS[cfg.obs_model],
            LANDMARK_TYPES[cfg.lm_type])


def _make_per_obs_residual(cfg: SolverConfig):
    """Whitened residual of ONE observation as a function of the tangent
    perturbation of its path edges and landmark (for jacfwd at zero)."""
    group, model, lmt = _resolve(cfg)
    D, pdof, ldof = cfg.max_depth, group.dof, lmt.dof

    def per_obs(eps, edge_pose, lm_state, z, lm_idx, p_edge, p_sign,
                whitener, sensor_pose_inv, calib):
        eps_e = eps[: D * pdof].reshape(D, pdof)
        eps_l = eps[D * pdof:]
        ident = group.identity(edge_pose.dtype)
        T = ident
        for k in range(D):  # static unroll: D is small (tree depth <= ~4)
            e = group.retract(edge_pose[p_edge[k]], eps_e[k])
            step = jnp.where(
                p_sign[k] > 0.5, e,
                jnp.where(p_sign[k] < -0.5, group.inverse(e), ident),
            )
            T = group.compose(T, step)
        lm = lmt.retract(lm_state[lm_idx], eps_l)
        if getattr(model, "is_pose_landmark", False):
            pred = group.compose(T, lm)  # graph-SLAM: compose, don't project
        else:
            pt = group.apply(T, lm)
            if cfg.use_sensor_pose:
                pt = group.apply(sensor_pose_inv, pt)
            pred = model.h(pt, calib)
        r = model.residual(pred, z)
        return whitener @ r

    return per_obs, D * pdof + ldof


def make_solver_impl(cfg: SolverConfig):
    """Build the UNJITTED LM optimizer implementation for one problem
    configuration (jit/shard_map wrapping happens in :func:`make_lm_solver`
    and :mod:`srba_tpu.parallel.sharding`).

    Returns ``(solve, eval_error)`` with
    ``solve(batch) -> (edge_pose, lm_state, info)`` where ``info`` is a dict
    of scalars (the analog of ``TOptimizeExtraOutputInfo``: ``err_init``,
    ``err_final``, ``iters``, ``lam``, ``num_obs``).

    When ``cfg.axis_name`` is set, the observation tables of the incoming
    batch are interpreted as THIS DEVICE'S SHARD: partial normal equations
    and error sums are ``psum``-reduced over the named mesh axis (the
    distributed Schur reduction of SURVEY.md §3.1), and the reduced system
    is solved replicated on every device.
    """
    group, model, lmt = _resolve(cfg)
    pdof, ldof = group.dof, lmt.dof
    per_obs, eps_dim = _make_per_obs_residual(cfg)

    def _residuals(edge_pose, lm_state, b: WindowBatch):
        eps0 = jnp.zeros((eps_dim,), edge_pose.dtype)
        f = lambda z, li, pe, ps: per_obs(
            eps0, edge_pose, lm_state, z, li, pe, ps,
            b.whitener, b.sensor_pose_inv, b.calib)
        return jax.vmap(f)(b.obs_z, b.obs_lm, b.path_edge, b.path_sign)

    def _psum(x):
        return (jax.lax.psum(x, cfg.axis_name)
                if cfg.axis_name is not None else x)

    def _psum_packed(*arrays):
        """One all-reduce ROUND for several arrays: flatten + concatenate
        + a single psum + split.  Collectives are latency-bound on every
        fabric (measured on the localhost-gloo ring: the 5 separate
        normal-equation psums per LM iteration, not the keyframe
        broadcast, dominate the cross-process per-KF cost); packing the
        tuple costs two reshuffles of data XLA already has in registers
        and cuts the rounds per iteration 5x."""
        if cfg.axis_name is None:
            return arrays
        flat = jnp.concatenate([a.reshape(-1) for a in arrays])
        summed = jax.lax.psum(flat, cfg.axis_name)
        out, off = [], 0
        for a in arrays:
            n = a.size
            out.append(summed[off: off + n].reshape(a.shape))
            off += n
        return tuple(out)

    def _prior_residuals(edge_pose, b: WindowBatch):
        """Per-edge prior residuals plog(inv(prior) o edge) [E, pdof] and
        their effective weights [E] (prior weight x opt mask)."""
        r = jax.vmap(lambda pr, e: group.plog(
            group.compose(group.inverse(pr), e)))(b.edge_prior, edge_pose)
        w = b.edge_prior_w * b.edge_opt
        return jnp.where(w[:, None] > 0, r, 0.0), w

    def _error(edge_pose, lm_state, b: WindowBatch):
        r = _residuals(edge_pose, lm_state, b)
        # where, not multiply: a NaN residual on a masked (padded) row must
        # not poison the sum.
        r = jnp.where(b.obs_valid[:, None] > 0, r, 0.0)
        sq = jnp.sum(r * r, axis=-1) * b.obs_valid
        if cfg.use_robust_kernel:
            err = _psum(jnp.sum(pseudo_huber_cost(sq, cfg.kernel_param)
                                * b.obs_valid))
        else:
            err = _psum(jnp.sum(sq))
        if b.edge_prior is not None:
            # Edge tables are replicated across the obs-sharded mesh, so the
            # prior cost is identical on every device — added AFTER the psum
            # (never robust-kerneled: priors are trusted measurements).
            rp, wp = _prior_residuals(edge_pose, b)
            err = err + jnp.sum(jnp.sum(rp * rp, axis=-1) * wp)
        return err

    def _build_normal_eqs(edge_pose, lm_state, b: WindowBatch):
        N, od = b.obs_z.shape[0], b.whitener.shape[0]
        E, L = b.edge_pose.shape[0], b.lm_state.shape[0]
        P = E * pdof
        eps0 = jnp.zeros((eps_dim,), edge_pose.dtype)

        def f(eps, z, li, pe, ps):
            return per_obs(eps, edge_pose, lm_state, z, li, pe, ps,
                           b.whitener, b.sensor_pose_inv, b.calib)

        r = jax.vmap(lambda z, li, pe, ps: f(eps0, z, li, pe, ps))(
            b.obs_z, b.obs_lm, b.path_edge, b.path_sign)          # [N, od]
        J = jax.vmap(
            lambda z, li, pe, ps: jax.jacfwd(f)(eps0, z, li, pe, ps)
        )(b.obs_z, b.obs_lm, b.path_edge, b.path_sign)            # [N, od, eps]

        # Mask padded rows with `where` (NaN-proof), then apply the IRLS row
        # scale: robust weight (frozen at linearization) x validity.
        valid = b.obs_valid[:, None] > 0
        r = jnp.where(valid, r, 0.0)
        J = jnp.where(valid[..., None], J, 0.0)
        sq = jnp.sum(r * r, axis=-1)
        w = (pseudo_huber_weight(sq, cfg.kernel_param)
             if cfg.use_robust_kernel else jnp.ones_like(sq))
        scale = jnp.sqrt(w) * b.obs_valid                          # [N]
        r = r * scale[:, None]
        J = J * scale[:, None, None]

        D = cfg.max_depth
        Jp_blocks = J[..., : D * pdof].reshape(N, od, D, pdof)
        Jl = J[..., D * pdof:]                                     # [N, od, ldof]
        Jl = Jl * b.lm_opt[b.obs_lm][:, None, None]

        seg = functools.partial(jax.ops.segment_sum,
                                segment_ids=b.obs_lm, num_segments=L)
        Hf = seg(jnp.einsum("noi,noj->nij", Jl, Jl))               # [L, l, l]
        gf = seg(jnp.einsum("noi,no->ni", Jl, r))                  # [L, l]

        if cfg.neq == "onehot":
            # Scatter path-edge blocks into the dense window Jacobian with
            # a one-hot contraction (a matmul instead of a scatter-add).
            onehot = jax.nn.one_hot(b.path_edge, E, dtype=r.dtype)  # [N,D,E]
            Jp = jnp.einsum("nodp,nde->noep", Jp_blocks, onehot)
            Jp = Jp * b.edge_opt[None, None, :, None]
            Jp2 = Jp.reshape(N * od, P)
            r_flat = r.reshape(N * od)
            Hp = Jp2.T @ Jp2                                       # [P, P]
            gp = Jp2.T @ r_flat                                    # [P]
            Hpf = seg(jnp.einsum("nop,noi->npi", Jp.reshape(N, od, P), Jl))
        else:
            # Segmented: per-depth-pair block products + segment-sums keyed
            # by the path-edge indices — never materializes the [N*od, P]
            # dense Jacobian (the memory wall at large windows).  Padded path
            # slots contribute exactly-zero blocks (their step is the
            # identity independent of eps), so their index-0 targets are
            # unaffected.
            pe = b.path_edge                                       # [N, D]
            emask = b.edge_opt[pe]                                 # [N, D]
            Jb = Jp_blocks * emask[:, None, :, None]               # [N,od,D,p]
            Bpp = jnp.einsum("nodi,noep->ndeip", Jb, Jb)   # [N,D,D,p,p]
            idx2 = (pe[:, :, None] * E + pe[:, None, :]).reshape(-1)
            Hp = jax.ops.segment_sum(
                Bpp.reshape(N * D * D, pdof, pdof), idx2,
                num_segments=E * E)
            Hp = Hp.reshape(E, E, pdof, pdof).transpose(
                0, 2, 1, 3).reshape(P, P)
            gb = jnp.einsum("nodi,no->ndi", Jb, r)                 # [N,D,p]
            gp = jax.ops.segment_sum(
                gb.reshape(N * D, pdof), pe.reshape(-1),
                num_segments=E).reshape(P)
            Cpl = jnp.einsum("nodi,nol->ndil", Jb, Jl)     # [N,D,p,l]
            idx_lf = (b.obs_lm[:, None] * E + pe).reshape(-1)
            Hpf = jax.ops.segment_sum(
                Cpl.reshape(N * D, pdof, ldof), idx_lf,
                num_segments=L * E).reshape(L, P, ldof)
        # Distributed Schur reduction: sum partial normal equations over the
        # observation-sharded mesh axis in ONE packed all-reduce round
        # (SURVEY.md §3.1).
        Hp, gp, Hf, gf, Hpf = _psum_packed(Hp, gp, Hf, gf, Hpf)

        if b.edge_prior is not None:
            # Edge measurement priors: block-diagonal H += w JtJ, g += w Jtr
            # per opt edge (replicated across the mesh: added post-psum).
            zeros_e = jnp.zeros((E, pdof), edge_pose.dtype)

            def per_prior(eps_e, prior, pose):
                return group.plog(group.compose(
                    group.inverse(prior), group.retract(pose, eps_e)))

            rp = jax.vmap(per_prior)(zeros_e, b.edge_prior, edge_pose)
            Jpr = jax.vmap(jax.jacfwd(per_prior))(
                zeros_e, b.edge_prior, edge_pose)        # [E, pdof, pdof]
            wp = b.edge_prior_w * b.edge_opt
            rp = jnp.where(wp[:, None] > 0, rp, 0.0)
            Jpr = jnp.where(wp[:, None, None] > 0, Jpr, 0.0)
            Hblk = wp[:, None, None] * jnp.einsum("eij,eik->ejk", Jpr, Jpr)
            gblk = wp[:, None] * jnp.einsum("eij,ei->ej", Jpr, rp)
            idx = jnp.arange(E)
            Hp = Hp.reshape(E, pdof, E, pdof).at[idx, :, idx, :].add(
                Hblk).reshape(P, P)
            gp = gp + gblk.reshape(P)
        return Hp, gp, Hf, gf, Hpf

    def _solve_delta(Hp, gp, Hf, gf, Hpf, lam, b: WindowBatch):
        E, L = b.edge_pose.shape[0], b.lm_state.shape[0]
        epm = jnp.repeat(b.edge_opt, pdof)                         # [P]
        diag_p = jnp.diagonal(Hp)
        Hp_d = Hp + jnp.diag(lam * diag_p + cfg.diag_floor + (1.0 - epm))

        diag_f = jnp.diagonal(Hf, axis1=-2, axis2=-1)              # [L, ldof]
        bump = lam * diag_f + cfg.diag_floor + (1.0 - b.lm_opt)[:, None]
        Hf_d = Hf + jax.vmap(jnp.diag)(bump)

        def _scaled_chol_solve(H, rhs):
            """Dense Cholesky with symmetric Jacobi equilibration:
            x = S (SHS)^-1 S rhs with S = diag(H)^{-1/2}.  The window
            systems mix pixel-unit Jacobians (fx ~ hundreds) with unit-norm
            quaternion tangents, giving diag(H) a ~1e6 dynamic range; in
            f32 the raw Cholesky's rounding then makes the lambda/accept
            path of the LM loop branch-unstable run to run (measured: the
            identical fixed-seed 8-iter stereo dryrun ended anywhere from
            4e-9 to 2e+1).  Equilibration bounds the condition exposure at
            ~sqrt(kappa) and costs two rank-1 scalings."""
            s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(H), 1e-20))
            Hs = H * s[:, None] * s[None, :]
            chol = jax.scipy.linalg.cho_factor(Hs)
            return s * jax.scipy.linalg.cho_solve(chol, rhs * s)

        if cfg.solver == "no_schur_dense_cholesky":
            # Full-system dense Cholesky (no landmark marginalization) —
            # the analog of the reference's no-Schur solver engine.
            P = E * pdof
            Q = L * ldof
            Hpf_full = Hpf.transpose(1, 0, 2).reshape(P, Q)
            Hf_full = jnp.zeros((L, ldof, L, ldof), Hf.dtype)
            idx = jnp.arange(L)
            Hf_full = Hf_full.at[idx, :, idx, :].set(Hf_d).reshape(Q, Q)
            H = jnp.block([[Hp_d, Hpf_full], [Hpf_full.T, Hf_full]])
            rhs = jnp.concatenate([gp, gf.reshape(Q)])
            delta = -_scaled_chol_solve(H, rhs)
            dp = delta[:P] * epm
            df = delta[P:].reshape(L, ldof) * b.lm_opt[:, None]
            return dp.reshape(E, pdof), df
        # Unrolled batched SPD inverse (ops/block_linalg.py): the landmark
        # blocks are 2x2/3x3 (6x6 in graph-SLAM) — jnp.linalg.inv serializes
        # per block, this vectorizes over L.
        Hf_inv = spd_inverse(Hf_d)                                 # [L, l, l]

        A = Hp_d - jnp.einsum("lpi,lij,lqj->pq", Hpf, Hf_inv, Hpf)
        rhs = gp - jnp.einsum("lpi,lij,lj->p", Hpf, Hf_inv, gf)
        dp = -_scaled_chol_solve(A, rhs) * epm                     # [P]
        # Back-substitute landmarks: df = Hf_inv (-gf - Hpf^T dp).
        df = jnp.einsum(
            "lij,lj->li", Hf_inv,
            -gf - jnp.einsum("lpi,p->li", Hpf, dp)
        ) * b.lm_opt[:, None]
        return dp.reshape(E, pdof), df

    def _apply(edge_pose, lm_state, dp, df):
        return group.retract(edge_pose, dp), lmt.retract(lm_state, df)

    def solve(b: WindowBatch):
        # Trace-time precision pin: on the GPU a float32 matmul may run in
        # TF32 by default (10-bit mantissa, ~3 decimal digits of input).
        # The normal equations / Schur products square the condition
        # number, so reduced-precision products visibly noise the
        # optimized state: landmark mirrors fed to the closure bootstrap
        # drift, marginal fits flip to rejection, and the 5k-KF mono run
        # starved of closures (12 vs 24, ATE 5.5 vs 0.8 for the same
        # pipeline at full f32) when an accelerator's default precision
        # was used.  "highest" keeps these products in true f32 (the FP32
        # units, not the tensor cores); its cost on the GPU is ROADMAP S3.
        with jax.default_matmul_precision("highest"):
            return _solve_body(b)

    def _solve_body(b: WindowBatch):
        err0 = _error(b.edge_pose, b.lm_state, b)
        it_cap = (cfg.max_iters if b.iters_cap is None
                  else jnp.minimum(b.iters_cap, cfg.max_iters))

        def cond(s):
            edge, lm, lam, err, it, rej, done, neqs = s
            return jnp.logical_and(jnp.logical_not(done), it < it_cap)

        def body(s):
            edge, lm, lam, err, it, rej, done, neqs = s
            # A rejected step leaves (edge, lm) unchanged — only lambda moved
            # — so the normal equations from the previous linearization are
            # still exact: reuse them instead of re-running the Jacobian /
            # Hessian assembly (the dominant cost of an iteration).
            neqs = jax.lax.cond(
                rej > 0,
                lambda: neqs,
                lambda: _build_normal_eqs(edge, lm, b))
            Hp, gp, Hf, gf, Hpf = neqs
            dp, df = _solve_delta(Hp, gp, Hf, gf, Hpf, lam, b)
            cand_e, cand_l = _apply(edge, lm, dp, df)
            err_new = _error(cand_e, cand_l, b)
            ok = jnp.isfinite(err_new)
            accept = jnp.logical_and(err_new < err, ok)
            edge = jnp.where(accept, cand_e, edge)
            lm = jnp.where(accept, cand_l, lm)
            lam = jnp.where(accept,
                            jnp.maximum(lam * cfg.lam_down, cfg.lam_min),
                            jnp.minimum(lam * cfg.lam_up, cfg.lam_max))
            rej = jnp.where(accept, 0, rej + 1)
            improved = (err - err_new) > cfg.rel_tol * (err + 1e-12)
            converged = jnp.logical_and(accept, jnp.logical_not(improved))
            # Stop on: converged accept; repeated rejects (at a local optimum
            # steps keep failing while lambda climbs); tiny error.
            done = jnp.logical_or(converged, rej >= cfg.max_consec_rejects)
            done = jnp.logical_or(done, err <= 1e-12)
            err = jnp.where(accept, err_new, err)
            return (edge, lm, lam, err, it + 1, rej, done, neqs)

        E, L = b.edge_pose.shape[0], b.lm_state.shape[0]
        P = E * pdof
        dt = b.edge_pose.dtype
        neqs0 = (jnp.zeros((P, P), dt), jnp.zeros((P,), dt),
                 jnp.zeros((L, ldof, ldof), dt), jnp.zeros((L, ldof), dt),
                 jnp.zeros((L, P, ldof), dt))
        init = (b.edge_pose, b.lm_state,
                jnp.asarray(cfg.lam0, b.edge_pose.dtype), err0,
                jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(False), neqs0)
        edge, lm, lam, err, it, _, _, _ = jax.lax.while_loop(cond, body, init)
        info = {
            "err_init": err0,
            "err_final": err,
            "iters": it,
            "lam": lam,
            "num_obs": _psum(jnp.sum(b.obs_valid)),
        }
        return edge, lm, info

    def eval_error(b: WindowBatch):
        with jax.default_matmul_precision("highest"):
            return _error(b.edge_pose, b.lm_state, b)

    return solve, eval_error


def make_lm_solver(cfg: SolverConfig):
    """Jitted single-device LM optimizer (see :func:`make_solver_impl`)."""
    assert cfg.axis_name is None, (
        "use srba_tpu.parallel.sharding for SPMD solvers")
    solve, eval_error = make_solver_impl(cfg)
    return jax.jit(solve), jax.jit(eval_error)


@functools.lru_cache(maxsize=None)
def get_solver(cfg: SolverConfig):
    """Cached solver factory — each distinct ``SolverConfig`` compiles once
    (the runtime analog of the reference's per-instantiation translation
    units in ``apps/srba-slam``)."""
    return make_lm_solver(cfg)
