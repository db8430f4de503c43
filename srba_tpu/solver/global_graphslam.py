"""Global pose-graph optimization (PGO) — the in-framework consumer of
``get_global_graphslam_problem``.

The reference exports its relative problem to an absolute-coordinate pose
graph and hands it to MRPT's external graph-slam Levenberg-Marquardt
(``impl/get_global_graphslam_problem.h`` + mrpt-graphs, public MRPT/srba
layout; SURVEY.md §1.3).  Here the global optimizer is first-class and
runs on the device:

* **Matrix-free Gauss-Newton/LM with block-Jacobi-preconditioned CG.**
  A dense Hessian over K poses is O((K·dof)²) — hopeless at 10k+ keyframes.
  But H = JᵀJ of a pose graph is graph-sparse: Hv needs only, per edge,
  the two [dof,dof] Jacobian blocks against the incident nodes.  Every CG
  iteration is therefore two batched block-matvecs over [E] edges plus two
  segment-sum scatters — batched elementwise/matmul work with static
  shapes, no sparse matrix storage at all.
* Per-edge Jacobian blocks come from forward-mode AD of the tangent-space
  residual at zero (the exact closed-form chain rule, derived by the
  compiler, batched with vmap) — re-linearized once per LM outer iteration.
* Gauge freedom is fixed by masking node 0's tangent.
* Everything (LM outer loop, CG inner loop) is ONE jitted program:
  ``lax.while_loop`` outside, ``lax.scan``-style CG inside.

Scale: 100k nodes × 6 dof = 600k unknowns is a few MB of state; the edge
tables dominate and stream at device-memory bandwidth.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from srba_tpu.ops.block_linalg import spd_inverse
from srba_tpu.ops.lie import GROUPS


@dataclass(frozen=True)
class PGOConfig:
    group: str
    max_outer: int = 30          # LM iterations (each re-linearizes)
    cg_iters: int = 50           # CG iterations per LM step
    lam0: float = 1e-4
    lam_up: float = 10.0
    lam_down: float = 0.1
    lam_min: float = 1e-10
    lam_max: float = 1e8
    # Convergence: an accepted step whose relative error decrease is below
    # rel_tol certifies the fixed point.  The error is an f32 accumulation
    # over up to ~100k edges (eps_f32 ~ 1.2e-7), so a tolerance below ~1e-6
    # is numerically unsatisfiable — LM then burns its full iteration budget
    # and reports "unconverged" on solves that plateaued long before
    # (measured round 3: the 20k-node bench re-entered +30 iterations for a
    # 2x cost and zero error change).  1e-5 is the f32-appropriate stop.
    rel_tol: float = 1e-5
    cg_rtol: float = 1e-6
    # Consecutive rejected steps before declaring the solve converged at a
    # local optimum: rejects only raise lambda, and once several in a row
    # fail the iterate is a fixed point for any useful step size.
    max_consec_rejects: int = 3
    # Absolute certification floor: mean robust cost per (valid) edge below
    # this is converged regardless of relative progress.  The IRLS robust
    # loss has a long geometric tail (measured: the 5k-node mono graph
    # improves > rel_tol for 60+ iterations while err sits at ~3e-6/edge =
    # millimeter-RMS residuals) — without a floor the solve burns its full
    # iteration budget to certify nothing.  5e-6/edge ~= 2 mm RMS tangent
    # residual at unit weight (measured sweep on the 5k mono graph: 5e-6
    # certifies in 3 iters at ATE 0.822 vs 60 uncertified iters for 0.798).
    # Raise it for graphs whose measurement noise floor is higher.
    abs_tol_per_edge: float = 5e-6
    # Robust edge loss: pseudo-Huber with this tangent-norm scale (None =
    # quadratic).  Implemented as IRLS: each LM outer iteration re-weights
    # every edge by rho'(s) of its CURRENT whitened squared norm, so biased
    # outlier edges (bad closures) lose influence instead of dragging the
    # whole graph (the reference exports to MRPT graph-slam LM, which has
    # the same robust-kernel option).
    robust_delta: Optional[float] = None
    # Per-component tangent weighting: rotation residuals (radians) vs
    # translation (meters).  A rotation error theta displaces every pose
    # downstream by ~r*theta, so information-weighting rotations by the map
    # scale is the g2o-standard practice (EDGE_SE3 info matrices put more
    # weight on the rotation block).
    rot_weight: float = 1.0
    # Chordal initialization (rotation averaging + linear translation solve,
    # solver/chordal.py) before LM-PCG: widens the convergence basin to
    # arbitrary orientation drift (multiple revolutions of accumulated yaw).
    # LM-PCG alone is local and traps there (docs/MATH.md).
    chordal_init: bool = False
    chordal_cg_iters: int = 300
    # Anisotropic per-edge information: when True the solve takes an extra
    # ``Wsqrt`` [E, dof, dof] operand (square root of the edge information
    # SHAPE, exported from closure-fit JtJs by io/export.py) and whitens
    # every edge residual/Jacobian with it — the full-matrix analog of the
    # reference's per-edge information matrices.  Identity rows reproduce
    # the scalar path bit-for-bit.
    use_edge_info: bool = False
    # SPMD: mesh axis the EDGE tables are sharded over.  Nodes stay
    # replicated; every edge-indexed reduction (gradient, Hv, block diag,
    # error) is psum'ed over this axis so the replicated LM/CG control flow
    # takes identical decisions on every device.
    axis_name: Optional[str] = None


def _make_residual(group):
    def residual(Ga, Gb, z, eps_a, eps_b):
        """Tangent residual of one edge constraint z = T_a<-b."""
        a = group.retract(Ga, eps_a)
        b = group.retract(Gb, eps_b)
        pred = group.compose(group.inverse(a), b)   # T_a<-b from globals
        return group.plog(group.compose(group.inverse(z), pred))
    return residual


@functools.lru_cache(maxsize=None)
def _make_pgo(cfg: PGOConfig):
    group = GROUPS[cfg.group]
    dof = group.dof
    res_fn = _make_residual(group)

    def _psum(x):
        return (jax.lax.psum(x, cfg.axis_name)
                if cfg.axis_name is not None else x)

    # Tangent layout is [translation, rotation] (ops/lie.py plog): SE2 dof 3
    # = 2+1, SE3 dof 6 = 3+3.
    t_dim = 2 if dof == 3 else 3

    def _comp(dtype):
        """Per-component information weights (translation 1, rotation
        cfg.rot_weight)."""
        return jnp.concatenate([
            jnp.ones((t_dim,), dtype),
            jnp.full((dof - t_dim,), cfg.rot_weight, dtype)])

    def _edge_sq(G, ea, eb, z, w, Wsqrt=None):
        """Per-edge whitened squared tangent norm s_e [E]."""
        zeros = jnp.zeros((ea.shape[0], dof), G.dtype)
        r = jax.vmap(res_fn)(G[ea], G[eb], z, zeros, zeros)
        if Wsqrt is not None:
            r = jnp.einsum("eij,ej->ei", Wsqrt, r)
        return jnp.sum(r * r * _comp(G.dtype)[None, :], axis=-1) * w

    def _robust_cost(s):
        """Pseudo-Huber rho(s) on the squared norm (quadratic near zero,
        linear-in-|r| far out); identity when no robust delta configured."""
        if cfg.robust_delta is None:
            return s
        d2 = cfg.robust_delta * cfg.robust_delta
        return 2.0 * d2 * (jnp.sqrt(1.0 + s / d2) - 1.0)

    def _robust_weight(s):
        """IRLS weight rho'(s) (Triggs et al.): down-weights edges whose
        current residual is far outside the quadratic basin."""
        if cfg.robust_delta is None:
            return jnp.ones_like(s)
        d2 = cfg.robust_delta * cfg.robust_delta
        return 1.0 / jnp.sqrt(1.0 + s / d2)

    def linearize(G, ea, eb, z, w, rw, Wsqrt=None):
        """Residuals r [E,dof] and Jacobian blocks A,B [E,dof,dof] wrt the
        tangents of the two incident nodes, weighted (static info weight w,
        per-component weights, robust IRLS weight rw, optional anisotropic
        information shape Wsqrt)."""
        zeros = jnp.zeros((ea.shape[0], dof), G.dtype)

        def per_edge(Ga, Gb, zi, e0a, e0b):
            return res_fn(Ga, Gb, zi, e0a, e0b)

        Ga, Gb = G[ea], G[eb]
        r = jax.vmap(per_edge)(Ga, Gb, z, zeros, zeros)
        A = jax.vmap(jax.jacfwd(per_edge, argnums=3))(Ga, Gb, z, zeros, zeros)
        B = jax.vmap(jax.jacfwd(per_edge, argnums=4))(Ga, Gb, z, zeros, zeros)
        if Wsqrt is not None:
            r = jnp.einsum("eij,ej->ei", Wsqrt, r)
            A = jnp.einsum("eij,ejk->eik", Wsqrt, A)
            B = jnp.einsum("eij,ejk->eik", Wsqrt, B)
        sw = jnp.sqrt(w * rw)[:, None] * jnp.sqrt(_comp(G.dtype))[None, :]
        return r * sw, A * sw[..., None], B * sw[..., None]

    def build_ops(K, ea, eb, A, B, gauge_mask):
        """Matrix-free H·v and Jᵀr over the edge-block structure."""

        def JT(r):
            # [K, dof] <- scatter AᵀrA to node a, BᵀrB to node b
            ga = jax.ops.segment_sum(
                jnp.einsum("eij,ei->ej", A, r), ea, num_segments=K)
            gb = jax.ops.segment_sum(
                jnp.einsum("eij,ei->ej", B, r), eb, num_segments=K)
            return _psum(ga + gb) * gauge_mask[:, None]

        def Hv(v):
            v = v * gauge_mask[:, None]
            u = (jnp.einsum("eij,ej->ei", A, v[ea])
                 + jnp.einsum("eij,ej->ei", B, v[eb]))
            return JT(u)

        def block_diag():
            # [K, dof, dof] block-Jacobi preconditioner blocks of H
            da = jax.ops.segment_sum(
                jnp.einsum("eij,eik->ejk", A, A), ea, num_segments=K)
            db = jax.ops.segment_sum(
                jnp.einsum("eij,eik->ejk", B, B), eb, num_segments=K)
            return _psum(da + db)

        return JT, Hv, block_diag

    if cfg.use_edge_info:
        def solve(G0, ea, eb, z, w, lam0, Wsqrt):
            """Anisotropic variant: ``Wsqrt`` [E, dof, dof] whitens every
            edge (see PGOConfig.use_edge_info); otherwise as below."""
            with jax.default_matmul_precision("highest"):
                return _solve_body(G0, ea, eb, z, w, lam0, Wsqrt)
    else:
        def solve(G0, ea, eb, z, w, lam0):
            """Returns (G_opt, info).  Shapes: G0 [K,pd]; ea/eb/w [E];
            z [E,pd]; ``lam0`` a scalar f32 — the LM damping warm start (a
            RUNTIME operand, not config: periodic refinements and
            escalations restart from the previous solve's final lambda
            without a recompile).  ``w`` carries validity (0 = padding
            edge) and constraint weight."""
            # True-f32 contractions (a TF32 matmul, the GPU's possible
            # default, noises the CG/Hv products; see the same pin in
            # solver/lm.py).
            with jax.default_matmul_precision("highest"):
                return _solve_body(G0, ea, eb, z, w, lam0, None)

    def _solve_body(G0, ea, eb, z, w, lam0, Wsqrt):
        K = G0.shape[0]
        gauge_mask = jnp.ones((K,), G0.dtype).at[0].set(0.0)
        err_floor = cfg.abs_tol_per_edge * _psum(jnp.sum(w > 0))

        def err_of(G):
            return _psum(jnp.sum(_robust_cost(
                _edge_sq(G, ea, eb, z, w, Wsqrt))))

        def cg(Hv, Minv_mul, b):
            """Preconditioned CG for H x = b (fixed iteration cap with
            early-exit on relative residual)."""
            x0 = jnp.zeros_like(b)
            r0 = b
            z0 = Minv_mul(r0)
            p0 = z0
            rz0 = jnp.vdot(r0, z0)
            bnorm = jnp.sqrt(jnp.vdot(b, b)) + 1e-30

            def cond(s):
                x, r, p, rz, it = s
                return jnp.logical_and(
                    it < cfg.cg_iters,
                    jnp.sqrt(jnp.vdot(r, r)) > cfg.cg_rtol * bnorm)

            def body(s):
                x, r, p, rz, it = s
                Hp = Hv(p)
                alpha = rz / (jnp.vdot(p, Hp) + 1e-30)
                x = x + alpha * p
                r = r - alpha * Hp
                zv = Minv_mul(r)
                rz_new = jnp.vdot(r, zv)
                beta = rz_new / (rz + 1e-30)
                p = zv + beta * p
                return (x, r, p, rz_new, it + 1)

            out = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
            return out[0], out[4]

        def lm_body(s):
            G, lam, err, it, rej, done, cg_total = s
            rw = _robust_weight(_edge_sq(G, ea, eb, z, w, Wsqrt))
            r, A, B = linearize(G, ea, eb, z, w, rw, Wsqrt)
            JT, Hv, block_diag = build_ops(K, ea, eb, A, B, gauge_mask)
            g = JT(r)                               # [K, dof]
            D = block_diag()                        # [K, dof, dof]
            # LM damping on the block diagonal (+1 on gauge/empty rows to
            # keep the preconditioner and the system SPD).
            diag_scale = jnp.einsum("kii->ki", D)
            bump = (lam * diag_scale + 1e-8
                    + (1.0 - gauge_mask)[:, None])
            D_d = D + jax.vmap(jnp.diag)(bump)
            # Batched small-SPD inverse (unrolled; see
            # ops/block_linalg.py for its time beside jnp.linalg.inv).
            Minv = spd_inverse(D_d)

            def Hv_damped(v):
                vb = v.reshape(K, dof)
                out = Hv(vb) + (lam * diag_scale + 1e-8) * vb * \
                    gauge_mask[:, None]
                return out.reshape(-1)

            def Minv_mul(v):
                return jnp.einsum(
                    "kij,kj->ki", Minv, v.reshape(K, dof)).reshape(-1)

            delta, cg_used = cg(Hv_damped, Minv_mul, -g.reshape(-1))
            delta = delta.reshape(K, dof) * gauge_mask[:, None]
            G_cand = group.retract(G, delta)
            err_new = err_of(G_cand)
            ok = jnp.isfinite(err_new)
            accept = jnp.logical_and(err_new < err, ok)
            G = jnp.where(accept, G_cand, G)
            lam = jnp.where(accept,
                            jnp.maximum(lam * cfg.lam_down, cfg.lam_min),
                            jnp.minimum(lam * cfg.lam_up, cfg.lam_max))
            improved = (err - err_new) > cfg.rel_tol * (err + 1e-30)
            rej = jnp.where(accept, 0, rej + 1)
            done = jnp.logical_or(
                jnp.logical_and(accept, jnp.logical_not(improved)),
                rej >= cfg.max_consec_rejects)
            err = jnp.where(accept, err_new, err)
            done = jnp.logical_or(done, err <= err_floor)
            return (G, lam, err, it + 1, rej, done, cg_total + cg_used)

        def lm_cond(s):
            G, lam, err, it, rej, done, cg_total = s
            return jnp.logical_and(jnp.logical_not(done),
                                   it < cfg.max_outer)

        if cfg.chordal_init:
            from srba_tpu.solver.chordal import make_chordal_init
            chordal = make_chordal_init(cfg.group, cfg.chordal_cg_iters,
                                        cg_rtol=cfg.cg_rtol,
                                        axis_name=cfg.axis_name)
            G0 = chordal(G0, ea, eb, z, w)
        err0 = err_of(G0)
        init = (G0, jnp.asarray(lam0, G0.dtype).reshape(()), err0,
                jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                err0 <= err_floor, jnp.asarray(0, jnp.int32))
        G, lam, err, it, rej, done, cg_total = jax.lax.while_loop(
            lm_cond, lm_body, init)
        # done=True means LM reached its relative-improvement fixed point;
        # otherwise the iteration budget ran out (caller should escalate).
        info = {"err_init": err0, "err_final": err, "iters": it,
                "lam": lam, "cg_iters_total": cg_total,
                "converged": done.astype(jnp.int32)}
        return G, info

    return solve


@functools.lru_cache(maxsize=None)
def _make_pgo_jit(cfg: PGOConfig):
    assert cfg.axis_name is None
    return jax.jit(_make_pgo(cfg))


_SPMD_PGO_CACHE: dict = {}


def make_pgo_spmd(cfg: PGOConfig, mesh):
    """Edge-sharded SPMD PGO over ``mesh``'s single axis: nodes replicated,
    edge tables split, per-edge reductions psum'ed (see PGOConfig.axis_name).
    Edge count must be a multiple of the mesh size (pad with w=0 edges).
    Cached per (cfg, mesh) so repeated calls reuse the compiled program."""
    from jax.sharding import PartitionSpec as P

    (axis,) = mesh.axis_names
    if cfg.axis_name != axis:
        cfg = dataclasses.replace(cfg, axis_name=axis)
    key = (cfg, tuple(mesh.shape.items()),
           tuple(d.id for d in mesh.devices.flat))
    hit = _SPMD_PGO_CACHE.get(key)
    if hit is not None:
        return hit
    solve = _make_pgo(cfg)
    repl = P()
    info_specs = {k: repl for k in ("err_init", "err_final", "iters", "lam",
                                    "cg_iters_total", "converged")}
    in_specs = [repl, P(axis), P(axis), P(axis), P(axis), repl]
    if cfg.use_edge_info:
        in_specs.append(P(axis))
    fn = jax.jit(jax.shard_map(
        solve, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(repl, info_specs),
        check_vma=False))
    _SPMD_PGO_CACHE[key] = fn
    return fn


def optimize_global_pose_graph(problem: dict,
                               cfg: PGOConfig | None = None,
                               weights: np.ndarray | None = None,
                               mesh=None, max_escalations: int = 1,
                               lam0: float | None = None):
    """Optimize an exported global pose-graph problem (the dict produced by
    :func:`srba_tpu.io.export.get_global_graphslam_problem`).

    Returns ``(nodes_opt [K, pose_dim] numpy, info dict)``.  Node 0 is the
    gauge (held fixed).  Unreachable nodes keep their input values.  With
    ``mesh``, the edge tables are sharded over its (single) axis.

    ``weights`` [E]: per-edge information (defaults to the problem's own
    ``edge_weights`` when the exporter provided them, else 1.0).  When the
    problem carries ``edge_info_sqrt`` [E, dof, dof] (anisotropic
    information shapes from closure-fit covariances, io/export.py) the
    solve whitens each edge with its matrix (PGOConfig.use_edge_info is
    switched on automatically).  ``lam0``
    warm-starts the LM damping (a runtime operand — no recompile; callers
    running periodic refinements pass the previous solve's final lambda so
    the re-entry skips the damping search).  When LM exits at the iteration
    cap unconverged, the solve is re-entered from the current iterate AND
    the current lambda up to ``max_escalations`` times (same compiled
    program — the warm restart costs no new compile) and a loud warning is
    printed if it STILL has not converged.
    """
    import sys

    group_name = problem["group"]
    if cfg is None:
        cfg = PGOConfig(group=group_name)
    assert cfg.group == group_name
    nodes = np.asarray(problem["nodes"], np.float32)
    edges = problem["edges"]
    E = len(edges)
    K = nodes.shape[0]
    if E == 0:
        return nodes, {"err_init": 0.0, "err_final": 0.0, "iters": 0,
                       "converged": 1}
    ea = np.asarray([e["from"] for e in edges], np.int32)
    eb = np.asarray([e["to"] for e in edges], np.int32)
    z = np.stack([np.asarray(e["rel_pose"], np.float32) for e in edges])
    if weights is None:
        weights = problem.get("edge_weights")
    w = (np.ones(E, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    Wsqrt = problem.get("edge_info_sqrt")
    if Wsqrt is not None:
        Wsqrt = np.asarray(Wsqrt, np.float32)
        cfg = dataclasses.replace(cfg, use_edge_info=True)
    elif cfg.use_edge_info:
        dof = 3 if nodes.shape[1] == 3 else 6
        Wsqrt = np.tile(np.eye(dof, dtype=np.float32), (E, 1, 1))

    # Power-of-two shape buckets: a growing map calls this repeatedly
    # (periodic global refinement) with a different (K, E) every time, and
    # each distinct shape is a fresh XLA compile (tens of seconds for
    # the chordal + LM-PCG program).  Padding nodes (edge-less: their
    # damped diagonal is identity, delta exactly 0) and edges (weight 0)
    # to buckets makes repeat calls hit the executable cache at O(log)
    # distinct shapes per run.
    Kp = max(256, 1 << (K - 1).bit_length())
    Ep = max(256, 1 << (E - 1).bit_length())
    if Kp != K:
        pad_nodes = np.tile(nodes[:1] * 0, (Kp - K, 1))
        if nodes.shape[1] == 7:
            pad_nodes[:, 3] = 1.0        # identity quaternion
        nodes = np.concatenate([nodes, pad_nodes])
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
        Ep = ((Ep + n_dev - 1) // n_dev) * n_dev
    if Ep != E:   # pad with weight-0 self-anchored edges
        pad = Ep - E
        ea = np.concatenate([ea, np.zeros(pad, np.int32)])
        eb = np.concatenate([eb, np.zeros(pad, np.int32)])
        z = np.concatenate([z, np.tile(z[:1], (pad, 1))])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
        if Wsqrt is not None:
            Wsqrt = np.concatenate([Wsqrt, np.tile(
                np.eye(Wsqrt.shape[-1], dtype=np.float32), (pad, 1, 1))])
    solve = make_pgo_spmd(cfg, mesh) if mesh is not None \
        else _make_pgo_jit(cfg)
    ea_d, eb_d, z_d, w_d = (jnp.asarray(ea), jnp.asarray(eb),
                            jnp.asarray(z), jnp.asarray(w))
    extra = () if Wsqrt is None else (jnp.asarray(Wsqrt),)
    lam_in = jnp.asarray(cfg.lam0 if lam0 is None else lam0, jnp.float32)
    G, info = solve(jnp.asarray(nodes), ea_d, eb_d, z_d, w_d, lam_in,
                    *extra)
    info = jax.device_get(info)
    err0, iters = float(info["err_init"]), float(info["iters"])
    # Unconverged at the iteration cap: warm-restart from the current
    # iterate AND current lambda, with chordal init off (it would reset the
    # iterate).  Same compiled program after the first escalation anywhere
    # in the process.
    esc = 0
    while not bool(info["converged"]) and esc < max_escalations:
        esc += 1
        esc_cfg = dataclasses.replace(cfg, chordal_init=False)
        esc_solve = (make_pgo_spmd(esc_cfg, mesh) if mesh is not None
                     else _make_pgo_jit(esc_cfg))
        G, info = esc_solve(G, ea_d, eb_d, z_d, w_d,
                            jnp.asarray(float(info["lam"]), jnp.float32),
                            *extra)
        info = jax.device_get(info)
        iters += float(info["iters"])
    if not bool(info["converged"]):
        print(f"[srba] WARNING: global PGO unconverged after {iters:.0f} LM "
              f"iterations ({esc} escalations); err "
              f"{err0:.3e}->{float(info['err_final']):.3e}",
              file=sys.stderr, flush=True)
    G = jax.device_get(G)
    out = {k: float(v) for k, v in info.items()}
    out.update(err_init=err0, iters=iters, escalations=float(esc))
    return np.asarray(G)[:K], out
