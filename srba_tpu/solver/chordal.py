"""Chordal initialization for global pose-graph optimization.

The LM-PCG optimizer (:mod:`srba_tpu.solver.global_graphslam`) is a local
method: with large accumulated orientation drift (multiple revolutions of
yaw error) it traps in poor basins (docs/MATH.md "known limits").  The
reference sidesteps the issue by exporting to MRPT's external optimizer
(``impl/get_global_graphslam_problem.h``, public MRPT/srba layout); an
in-framework optimizer must own its basin problem, so this module provides
the standard two-stage *chordal* initializer (Martinec-Pajdla style rotation
averaging, the same relaxation SE-Sync/chordal-init literature uses):

1. **Rotation averaging (chordal relaxation).**  Relax each global rotation
   to an unconstrained ``d x d`` matrix ``M_k`` and minimize the convex
   quadratic ``sum_e w_e ||M_a R_ab - M_b||_F^2`` (+ a gauge anchor on node
   0, + a Tikhonov pull toward the input so disconnected nodes are
   untouched).  The normal equations are graph-sparse; they are solved
   MATRIX-FREE with Jacobi-preconditioned CG — per iteration two batched
   ``[E, d, d]`` matmuls and two ``segment_sum`` scatters, the exact same
   static-shape skeleton as the PGO's Hv.  Each ``M_k`` is then projected to
   SO(d) (closed form for d=2; batched SVD for d=3).
2. **Translation recovery.**  With rotations fixed, the translation
   constraints ``t_b - t_a = R_a t_ab`` are linear: one more Jacobi-CG on
   the graph Laplacian.

Both stages are pure ``jnp`` with static shapes and run inside the PGO's
jitted program (enable with ``PGOConfig(chordal_init=True)``); edge-indexed
reductions psum over ``axis_name`` so the edge-sharded SPMD path
(:func:`srba_tpu.solver.global_graphslam.make_pgo_spmd`) distributes the
initializer along with the optimizer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from srba_tpu.ops.lie import quat_to_matrix


def _so2_from_theta(theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)


def _matrix_to_quat(R):
    """Batched rotation matrix -> unit quaternion (w, x, y, z); Shepperd's
    method as a branchless 4-way select (jit/vmap-safe)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions, each numerically good in its own region.
    sw = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-12)) * 0.5          # = |qw|
    qw_w, qx_w = sw, (m21 - m12) / (4.0 * sw + 1e-30)
    qy_w, qz_w = (m02 - m20) / (4.0 * sw + 1e-30), \
        (m10 - m01) / (4.0 * sw + 1e-30)
    sx = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 0.5
    qw_x, qx_x = (m21 - m12) / (4.0 * sx + 1e-30), sx
    qy_x, qz_x = (m01 + m10) / (4.0 * sx + 1e-30), \
        (m02 + m20) / (4.0 * sx + 1e-30)
    sy = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 0.5
    qw_y, qx_y = (m02 - m20) / (4.0 * sy + 1e-30), \
        (m01 + m10) / (4.0 * sy + 1e-30)
    qy_y, qz_y = sy, (m12 + m21) / (4.0 * sy + 1e-30)
    sz = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 0.5
    qw_z, qx_z = (m10 - m01) / (4.0 * sz + 1e-30), \
        (m02 + m20) / (4.0 * sz + 1e-30)
    qy_z, qz_z = (m12 + m21) / (4.0 * sz + 1e-30), sz

    cands = jnp.stack([
        jnp.stack([qw_w, qx_w, qy_w, qz_w], -1),
        jnp.stack([qw_x, qx_x, qy_x, qz_x], -1),
        jnp.stack([qw_y, qx_y, qy_y, qz_y], -1),
        jnp.stack([qw_z, qx_z, qy_z, qz_z], -1),
    ], -2)                                                     # [..., 4, 4]
    scores = jnp.stack([tr, m00, m11, m22], -1)                # [..., 4]
    pick = jax.nn.one_hot(jnp.argmax(scores, -1), 4, dtype=R.dtype)
    q = jnp.einsum("...c,...cq->...q", pick, cands)
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-30)


def _project_so(M, d: int):
    """Closest rotation to each ``d x d`` matrix (Frobenius)."""
    if d == 2:
        # argmax_theta <M, R(theta)> -> theta = atan2(m10-m01, m00+m11).
        th = jnp.arctan2(M[..., 1, 0] - M[..., 0, 1],
                         M[..., 0, 0] + M[..., 1, 1])
        return _so2_from_theta(th), th
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt))
    S = jnp.concatenate(
        [jnp.ones(M.shape[:-2] + (2,), M.dtype), det[..., None]], -1)
    R = jnp.einsum("...ij,...j,...jk->...ik", U, S, Vt)
    return R, None


def _jacobi_cg(Hv, rhs, x0, dinv, iters: int, rtol: float):
    """Jacobi-preconditioned CG on flattened unknowns (fixed cap, early-exit
    on relative residual) — same shape discipline as the PGO's inner CG."""
    r0 = rhs - Hv(x0)
    z0 = dinv * r0
    rz0 = jnp.vdot(r0, z0)
    bnorm = jnp.sqrt(jnp.vdot(rhs, rhs)) + 1e-30

    def cond(s):
        x, r, p, rz, it = s
        return jnp.logical_and(it < iters,
                               jnp.sqrt(jnp.vdot(r, r)) > rtol * bnorm)

    def body(s):
        x, r, p, rz, it = s
        Hp = Hv(p)
        alpha = rz / (jnp.vdot(p, Hp) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        zv = dinv * r
        rz_new = jnp.vdot(r, zv)
        p = zv + (rz_new / (rz + 1e-30)) * p
        return (x, r, p, rz_new, it + 1)

    out = jax.lax.while_loop(cond, body, (x0, r0, z0, rz0, 0))
    return out[0]


def make_chordal_init(group_name: str, cg_iters: int = 300,
                      cg_rtol: float = 1e-7, axis_name=None):
    """Build ``init(G0, ea, eb, z, w) -> G_init`` for the given group
    ("SE2"/"SE3").  Pure jnp; shapes as in the PGO solver.  ``w == 0`` rows
    are padding.  Nodes touched by no edge keep their ``G0`` values."""
    d = 2 if group_name == "SE2" else 3
    dd = d * d
    ridge = 1e-6

    def _psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def rotmats(G):
        if group_name == "SE2":
            return _so2_from_theta(G[..., 2])
        return quat_to_matrix(G[..., 3:])

    def init(G0, ea, eb, z, w):
        K = G0.shape[0]
        dt = G0.dtype
        R0 = rotmats(G0)                                        # [K, d, d]
        Rz = rotmats(z)                                         # [E, d, d]
        t0 = G0[..., :d]                                        # [K, d]
        tz = z[..., :d]                                         # [E, d]
        w_mean = _psum(jnp.sum(w)) / jnp.maximum(
            _psum(jnp.sum(w > 0)), 1.0)
        anchor = jnp.zeros((K,), dt).at[0].set(w_mean)          # gauge

        # Degree (for the Jacobi preconditioner): per-node sum of incident
        # edge weights + anchor + Tikhonov ridge.
        deg = _psum(
            jax.ops.segment_sum(w, ea, num_segments=K)
            + jax.ops.segment_sum(w, eb, num_segments=K)) + anchor + ridge

        # ---- Stage 1: rotation averaging ----------------------------------
        # min sum_e w ||M_a Rz_e - M_b||^2 + anchor ||M_0 - R0_0||^2
        #   + ridge ||M - R0||^2   (the ridge keeps untouched nodes at R0).
        def Hv_rot(x):
            M = x.reshape(K, d, d)
            u = (jnp.einsum("eij,ejk->eik", M[ea], Rz)
                 - M[eb]) * w[:, None, None]
            ga = jax.ops.segment_sum(
                jnp.einsum("eik,ejk->eij", u, Rz), ea, num_segments=K)
            gb = jax.ops.segment_sum(-u, eb, num_segments=K)
            out = _psum(ga + gb) + (anchor + ridge)[:, None, None] * M
            return out.reshape(-1)

        rhs_rot = ((anchor + ridge)[:, None, None] * R0).reshape(-1)
        dinv_rot = jnp.repeat(1.0 / deg, dd)
        M = _jacobi_cg(Hv_rot, rhs_rot, R0.reshape(-1), dinv_rot,
                       cg_iters, cg_rtol).reshape(K, d, d)
        R, th = _project_so(M, d)

        # ---- Stage 2: linear translation recovery -------------------------
        # min sum_e w ||t_b - t_a - R_a tz_e||^2 + anchor + ridge-to-t0.
        b_e = jnp.einsum("eij,ej->ei", R[ea], tz) * w[:, None]  # [E, d]

        def Hv_t(x):
            t = x.reshape(K, d)
            u = (t[eb] - t[ea]) * w[:, None]
            ga = jax.ops.segment_sum(-u, ea, num_segments=K)
            gb = jax.ops.segment_sum(u, eb, num_segments=K)
            out = _psum(ga + gb) + (anchor + ridge)[:, None] * t
            return out.reshape(-1)

        rhs_t = (_psum(jax.ops.segment_sum(b_e, eb, num_segments=K)
                       - jax.ops.segment_sum(b_e, ea, num_segments=K))
                 + (anchor + ridge)[:, None] * t0).reshape(-1)
        dinv_t = jnp.repeat(1.0 / deg, d)
        t = _jacobi_cg(Hv_t, rhs_t, t0.reshape(-1), dinv_t,
                       cg_iters, cg_rtol).reshape(K, d)

        if group_name == "SE2":
            return jnp.concatenate([t, th[:, None]], axis=-1)
        return jnp.concatenate([t, _matrix_to_quat(R)], axis=-1)

    return init
