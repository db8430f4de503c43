"""Batched SE(2)/SE(3) Lie-group operations — the batched analog of the
reference's pose substrate (MRPT ``CPose2D``/``CPose3D`` composition and the
``SE_traits<2/3>`` pseudo-exponential retraction; see SURVEY.md L0 and
``include/srba/models/kf2kf_poses.h`` in the public MRPT/srba layout).

Design notes (batched-device first, not a port):

* Everything here is shape-polymorphic over leading batch dimensions and built
  from pure ``jnp`` primitives, so it vmaps/jits/shards freely.  Poses are
  stored as flat arrays — SE(2) as ``[..., 3] = (x, y, theta)`` and SE(3) as
  ``[..., 7] = (tx, ty, tz, qw, qx, qy, qz)`` (unit quaternion, scalar first).
  Quaternions beat 3x3 matrices here: compose chains along spanning-tree paths
  are long sequences of tiny elementwise products, and 4-wide state halves
  the memory traffic of 9-wide rotation matrices.
* The retraction is the MRPT-style **pseudo-exponential**: the translational
  part of the tangent is applied directly (no V-matrix coupling), the
  rotational part through the SO(2)/SO(3) exponential.  The optimizer computes
  Jacobians *with respect to this retraction* via forward-mode AD at delta=0,
  so retraction and Jacobians are consistent by construction.
* No data-dependent control flow: angle wrapping uses ``atan2``; quaternion
  exp/log use the ``sinc``-style Taylor switch via ``jnp.where`` on a safe
  denominator, which XLA fuses into straight-line elementwise code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Small angle threshold for exp/log Taylor branches (f32-safe).
_EPS = 1e-8


def wrap_angle(theta):
    """Wrap angles to (-pi, pi] without branching."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


# ---------------------------------------------------------------------------
# Quaternions: scalar-first (w, x, y, z), unit norm.
# ---------------------------------------------------------------------------


def quat_mul(q1, q2):
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v):
    """Rotate 3-vectors ``v`` by unit quaternions ``q`` (batched)."""
    w = q[..., :1]
    u = q[..., 1:]
    # v' = v + 2 w (u x v) + 2 u x (u x v)
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_exp(omega):
    """SO(3) exponential: rotation vector ``[..., 3]`` -> unit quaternion."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    # sin(x/2)/x with Taylor fallback: 0.5 - theta^2/48 for tiny theta.
    small = theta2 < _EPS
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([w, k * omega], axis=-1))


def quat_log(q):
    """Unit quaternion -> rotation vector ``[..., 3]`` (inverse of quat_exp)."""
    # Force the w >= 0 hemisphere so the result angle is in [0, pi].
    sign = jnp.where(q[..., :1] < 0.0, -1.0, 1.0)
    q = q * sign
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn2 = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1, keepdims=True)
    vn = jnp.sqrt(vn2 + _EPS * _EPS)
    angle = 2.0 * jnp.arctan2(vn, w)
    small = vn2 < _EPS
    k = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / vn)
    return k * q[..., 1:]


def quat_to_matrix(q):
    """Unit quaternion ``[..., 4]`` -> rotation matrix ``[..., 3, 3]``."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_from_yaw_pitch_roll(yaw, pitch, roll):
    """Z-Y-X intrinsic Euler angles -> quaternion (MRPT CPose3D convention)."""
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# SE(2): pose = (x, y, theta).  Acts on 2D points.
# ---------------------------------------------------------------------------


class SE2:
    """SE(2) group descriptor. ``dim``: storage width, ``dof``: tangent width."""

    dim = 3
    dof = 3
    point_dim = 2
    name = "SE2"

    @staticmethod
    def identity(dtype=jnp.float32):
        return jnp.zeros((3,), dtype=dtype)

    @staticmethod
    def compose(a, b):
        """Pose of frame C in A given a = T_A<-B, b = T_B<-C."""
        ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
        x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
        y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
        th = wrap_angle(a[..., 2] + b[..., 2])
        return jnp.stack([x, y, th], axis=-1)

    @staticmethod
    def inverse(a):
        ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
        x = -(ca * a[..., 0] + sa * a[..., 1])
        y = -(-sa * a[..., 0] + ca * a[..., 1])
        return jnp.stack([x, y, -a[..., 2]], axis=-1)

    @staticmethod
    def apply(a, pt):
        """Map points from the child frame into the parent frame."""
        ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
        x = a[..., 0] + ca * pt[..., 0] - sa * pt[..., 1]
        y = a[..., 1] + sa * pt[..., 0] + ca * pt[..., 1]
        return jnp.stack([x, y], axis=-1)

    @staticmethod
    def pexp(delta):
        """Pseudo-exponential: tangent (dx, dy, dtheta) -> pose, translation direct."""
        return delta

    @staticmethod
    def plog(pose):
        return pose

    @staticmethod
    def retract(pose, delta):
        return SE2.compose(pose, SE2.pexp(delta))

    @staticmethod
    def local_err(a, b):
        """Tangent of ``inverse(a) . b`` — residual for relative-pose observations."""
        d = SE2.compose(SE2.inverse(a), b)
        return jnp.concatenate([d[..., :2], wrap_angle(d[..., 2:3])], axis=-1)

    @staticmethod
    def normalize(pose):
        return jnp.concatenate(
            [pose[..., :2], wrap_angle(pose[..., 2:3])], axis=-1
        )

    @staticmethod
    def rand(key, n, trans_scale=1.0, dtype=jnp.float32):
        k1, k2 = jax.random.split(key)
        xy = jax.random.normal(k1, (n, 2), dtype) * trans_scale
        th = jax.random.uniform(k2, (n, 1), dtype, -jnp.pi, jnp.pi)
        return jnp.concatenate([xy, th], axis=-1)


# ---------------------------------------------------------------------------
# SE(3): pose = (tx, ty, tz, qw, qx, qy, qz).  Acts on 3D points.
# ---------------------------------------------------------------------------


class SE3:
    dim = 7
    dof = 6
    point_dim = 3
    name = "SE3"

    @staticmethod
    def identity(dtype=jnp.float32):
        return jnp.asarray([0, 0, 0, 1, 0, 0, 0], dtype=dtype)

    @staticmethod
    def compose(a, b):
        t = a[..., :3] + quat_rotate(a[..., 3:], b[..., :3])
        q = quat_mul(a[..., 3:], b[..., 3:])
        return jnp.concatenate([t, quat_normalize(q)], axis=-1)

    @staticmethod
    def inverse(a):
        qi = quat_conj(a[..., 3:])
        return jnp.concatenate([-quat_rotate(qi, a[..., :3]), qi], axis=-1)

    @staticmethod
    def apply(a, pt):
        return a[..., :3] + quat_rotate(a[..., 3:], pt)

    @staticmethod
    def pexp(delta):
        """Pseudo-exp: (dt[3], dw[3]) -> pose; translation direct, rotation exp."""
        return jnp.concatenate([delta[..., :3], quat_exp(delta[..., 3:])], axis=-1)

    @staticmethod
    def plog(pose):
        return jnp.concatenate([pose[..., :3], quat_log(pose[..., 3:])], axis=-1)

    @staticmethod
    def retract(pose, delta):
        return SE3.compose(pose, SE3.pexp(delta))

    @staticmethod
    def local_err(a, b):
        return SE3.plog(SE3.compose(SE3.inverse(a), b))

    @staticmethod
    def normalize(pose):
        return jnp.concatenate(
            [pose[..., :3], quat_normalize(pose[..., 3:])], axis=-1
        )

    @staticmethod
    def from_xyz_ypr(x, y, z, yaw=0.0, pitch=0.0, roll=0.0, dtype=jnp.float32):
        t = jnp.stack(
            [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)],
            axis=-1,
        )
        q = quat_from_yaw_pitch_roll(
            jnp.asarray(yaw, dtype), jnp.asarray(pitch, dtype), jnp.asarray(roll, dtype)
        )
        return jnp.concatenate([t, q], axis=-1)

    @staticmethod
    def rand(key, n, trans_scale=1.0, dtype=jnp.float32):
        k1, k2 = jax.random.split(key)
        t = jax.random.normal(k1, (n, 3), dtype) * trans_scale
        w = jax.random.normal(k2, (n, 3), dtype)
        return jnp.concatenate([t, quat_exp(w)], axis=-1)


GROUPS = {"SE2": SE2, "SE3": SE3}


def se2_to_se3(pose2):
    """Embed SE(2) poses in SE(3) (z=0, yaw-only rotation)."""
    zeros = jnp.zeros_like(pose2[..., :1])
    half = pose2[..., 2:3] * 0.5
    return jnp.concatenate(
        [pose2[..., :2], zeros, jnp.cos(half), zeros, zeros, jnp.sin(half)],
        axis=-1,
    )
