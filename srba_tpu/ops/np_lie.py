"""Host-side (numpy) mirrors of the SE(2)/SE(3) operations in
:mod:`srba_tpu.ops.lie`.

Why a separate module: with an accelerator backend active, every ``jnp``
call is a device dispatch (and a blocking download to read back).  The
engine's host bookkeeping — composing a handful of poses for exporters,
global-map recovery, or debugging — must not pay that per tiny op.  These are
the same formulas on numpy arrays; ``tests/test_np_lie.py`` pins them against
the jnp versions.

Device code must never import this module.
"""

from __future__ import annotations

import numpy as np


def wrap_angle(theta):
    return np.arctan2(np.sin(theta), np.cos(theta))


# -- quaternions (w, x, y, z) ----------------------------------------------


def quat_mul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_exp(omega):
    omega = np.asarray(omega, np.float64)
    theta = np.linalg.norm(omega, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    half = 0.5 * theta
    k = np.sin(half) / theta
    return quat_normalize(
        np.concatenate([np.cos(half), k * omega], axis=-1))


def quat_log(q):
    q = np.asarray(q, np.float64)
    sign = np.where(q[..., :1] < 0.0, -1.0, 1.0)
    q = q * sign
    w = np.clip(q[..., :1], -1.0, 1.0)
    vn = np.maximum(np.linalg.norm(q[..., 1:], axis=-1, keepdims=True), 1e-12)
    angle = 2.0 * np.arctan2(vn, w)
    return (angle / vn) * q[..., 1:]


def quat_from_matrix(R):
    """Rotation matrix (3x3) -> unit quaternion (w, x, y, z), single pose."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[1 + i] = 0.25 * s
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    return quat_normalize(np.asarray([w, x, y, z]))


# Camera mounting: robot frame is x-forward/y-left/z-up; camera frame is
# z-forward/x-right/y-down.  ``CAMERA_SENSOR_POSE_SE3`` is the camera pose on
# the robot (T_robot<-camera) in 7-vector storage — pass it as the engine's
# ``SensorPoseSE3`` for camera observation models.
_R_ROBOT_FROM_CAM = np.asarray([[0.0, 0.0, 1.0],
                                [-1.0, 0.0, 0.0],
                                [0.0, -1.0, 0.0]])
CAMERA_SENSOR_POSE_SE3 = np.concatenate(
    [np.zeros(3), quat_from_matrix(_R_ROBOT_FROM_CAM)]).astype(np.float32)


class NpSE2:
    dim = 3
    dof = 3
    point_dim = 2

    @staticmethod
    def identity(dtype=np.float32):
        return np.zeros(3, dtype=dtype)

    @staticmethod
    def compose(a, b):
        a, b = np.asarray(a), np.asarray(b)
        ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack(
            [
                a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                wrap_angle(a[..., 2] + b[..., 2]),
            ],
            axis=-1,
        )

    @staticmethod
    def inverse(a):
        a = np.asarray(a)
        ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack(
            [
                -(ca * a[..., 0] + sa * a[..., 1]),
                -(-sa * a[..., 0] + ca * a[..., 1]),
                -a[..., 2],
            ],
            axis=-1,
        )

    @staticmethod
    def apply(a, pt):
        a, pt = np.asarray(a), np.asarray(pt)
        ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack(
            [
                a[..., 0] + ca * pt[..., 0] - sa * pt[..., 1],
                a[..., 1] + sa * pt[..., 0] + ca * pt[..., 1],
            ],
            axis=-1,
        )

    @staticmethod
    def pexp(delta):
        return np.asarray(delta)

    @staticmethod
    def plog(pose):
        return np.asarray(pose)

    @classmethod
    def retract(cls, pose, delta):
        return cls.compose(pose, cls.pexp(delta))


class NpSE3:
    dim = 7
    dof = 6
    point_dim = 3

    @staticmethod
    def identity(dtype=np.float32):
        return np.asarray([0, 0, 0, 1, 0, 0, 0], dtype=dtype)

    @staticmethod
    def compose(a, b):
        a, b = np.asarray(a), np.asarray(b)
        t = a[..., :3] + quat_rotate(a[..., 3:], b[..., :3])
        q = quat_normalize(quat_mul(a[..., 3:], b[..., 3:]))
        return np.concatenate([t, q], axis=-1)

    @staticmethod
    def inverse(a):
        a = np.asarray(a)
        qi = quat_conj(a[..., 3:])
        return np.concatenate([-quat_rotate(qi, a[..., :3]), qi], axis=-1)

    @staticmethod
    def apply(a, pt):
        a, pt = np.asarray(a), np.asarray(pt)
        return a[..., :3] + quat_rotate(a[..., 3:], pt)

    @staticmethod
    def pexp(delta):
        delta = np.asarray(delta)
        return np.concatenate(
            [delta[..., :3], quat_exp(delta[..., 3:])], axis=-1)

    @staticmethod
    def plog(pose):
        pose = np.asarray(pose)
        return np.concatenate(
            [pose[..., :3], quat_log(pose[..., 3:])], axis=-1)

    @classmethod
    def retract(cls, pose, delta):
        return cls.compose(pose, cls.pexp(delta))


NP_GROUPS = {"SE2": NpSE2, "SE3": NpSE3}


def np_group_for(group):
    """Map a device group descriptor (SE2/SE3) to its numpy mirror."""
    return NP_GROUPS[group.name]


def compose_path(np_group, edge_poses: np.ndarray, path) -> np.ndarray:
    """Compose ``T_src<-dst`` along a spanning-tree ``path`` of
    ``(edge_id, sign)`` steps (host-side; device composes inside the jitted
    solver instead)."""
    T = np_group.identity()
    for eid, sign in path:
        e = edge_poses[eid]
        T = np_group.compose(T, e if sign == 1 else np_group.inverse(e))
    return T
