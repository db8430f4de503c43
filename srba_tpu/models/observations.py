"""Observation (sensor) models: prediction ``h(.)``, residuals, and inverse
sensor models for landmark initialization.

Batched re-design of the reference model library (public MRPT/srba layout:
``include/srba/models/observations.h`` and ``models/sensors.h`` — the
``observations::{MonocularCamera, StereoCamera, Cartesian_2D/3D,
RangeBearing_2D/3D, RelativePoses_2D/3D}`` types and their ``sensor_model``
specializations; see SURVEY.md §3).

Differences from the reference, on purpose:

* Every ``h``/``residual`` is a pure batched jnp function of the landmark
  position *already expressed in the sensor frame* — pose-chain composition
  (spanning-tree path) and sensor-mounting transforms are handled upstream by
  the solver, so each model stays a tiny vmappable kernel.
* The reference ships hand-derived closed-form Jacobians
  (``sensor_model::eval_jacob_dh_dx``).  Here Jacobians come from forward-mode
  AD of these functions under ``jax.jacfwd`` — exact, consistent with the
  pseudo-exponential retraction, and fused by XLA into the same straight-line
  code a hand derivation would give.  Unit tests cross-check against finite
  differences (the reference's debug-mode check, SURVEY.md §5).
* Calibration structs are pytree dataclasses (the analog of
  ``mrpt::utils::TCamera`` / ``TStereoCamera``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from srba_tpu.ops.lie import SE2, SE3, wrap_angle


def _xp(a):
    """Namespace dispatch: numpy in -> numpy out (host path, no device
    round-trip), anything else -> jnp.  Used by the ``inverse`` sensor
    models (host-side landmark initialization) and by the point-model ``h``
    functions so dataset generation runs entirely on the host (numpy calib
    in, numpy out) — under jit the operand is a tracer and the jnp branch
    is taken, so the solver path is unchanged."""
    return np if isinstance(a, np.ndarray) else jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """Pinhole calibration (analog of ``mrpt::utils::TCamera``).

    Leaves are HOST numpy scalars: jit consumes them as operands exactly
    like device arrays, while host-side consumers (dataset generation,
    inverse sensor models, closure bootstrap) read them without a blocking
    device fetch."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @staticmethod
    def make(fx=200.0, fy=200.0, cx=160.0, cy=120.0, dtype=np.float32):
        return CameraCalib(
            fx=np.asarray(fx, dtype), fy=np.asarray(fy, dtype),
            cx=np.asarray(cx, dtype), cy=np.asarray(cy, dtype),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StereoCalib:
    """Rectified stereo calibration (analog of ``TStereoCamera``): identical
    left/right pinholes separated along +x by ``baseline``."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    baseline: jnp.ndarray

    @staticmethod
    def make(fx=200.0, fy=200.0, cx=160.0, cy=120.0, baseline=0.12,
             dtype=np.float32):
        return StereoCalib(
            fx=np.asarray(fx, dtype), fy=np.asarray(fy, dtype),
            cx=np.asarray(cx, dtype), cy=np.asarray(cy, dtype),
            baseline=np.asarray(baseline, dtype),
        )


# Small positive floor to keep divisions/atan2 well-defined on padded
# (masked-out) lanes without branching.
_SAFE = 1e-9


class _PointObs:
    """Base for landmark-point observation models (everything except the
    relative-pose graph-SLAM modes)."""

    has_inverse_model = True
    is_pose_landmark = False

    @classmethod
    def residual(cls, pred, z):
        return pred - z


class Cartesian2D(_PointObs):
    """Direct 2D sensor-frame coordinates of the landmark.  obs = (x, y)."""

    name = "Cartesian2D"
    obs_dim = 2
    lm_dim = 2
    pose_group = SE2

    @staticmethod
    def h(lm_in_sensor, calib=None):
        return lm_in_sensor

    @staticmethod
    def inverse(z, calib=None):
        return z


class Cartesian3D(_PointObs):
    """Direct 3D sensor-frame coordinates.  obs = (x, y, z)."""

    name = "Cartesian3D"
    obs_dim = 3
    lm_dim = 3
    pose_group = SE3

    @staticmethod
    def h(lm_in_sensor, calib=None):
        return lm_in_sensor

    @staticmethod
    def inverse(z, calib=None):
        return z


class RangeBearing2D(_PointObs):
    """obs = (range, yaw) of a 2D landmark from the sensor."""

    name = "RangeBearing2D"
    obs_dim = 2
    lm_dim = 2
    pose_group = SE2

    @staticmethod
    def h(lm_in_sensor, calib=None):
        xp = _xp(lm_in_sensor)
        x, y = lm_in_sensor[..., 0], lm_in_sensor[..., 1]
        r = xp.sqrt(x * x + y * y + _SAFE)
        yaw = xp.arctan2(y, x + _SAFE)
        return xp.stack([r, yaw], axis=-1)

    @classmethod
    def residual(cls, pred, z):
        d = pred - z
        return jnp.concatenate(
            [d[..., :1], wrap_angle(d[..., 1:2])], axis=-1
        )

    @staticmethod
    def inverse(z, calib=None):
        xp = _xp(z)
        r, yaw = z[..., 0], z[..., 1]
        return xp.stack([r * xp.cos(yaw), r * xp.sin(yaw)], axis=-1)


class RangeBearing3D(_PointObs):
    """obs = (range, yaw, pitch) of a 3D landmark from the sensor."""

    name = "RangeBearing3D"
    obs_dim = 3
    lm_dim = 3
    pose_group = SE3

    @staticmethod
    def h(lm_in_sensor, calib=None):
        xp = _xp(lm_in_sensor)
        x, y, z = (lm_in_sensor[..., 0], lm_in_sensor[..., 1],
                   lm_in_sensor[..., 2])
        r = xp.sqrt(x * x + y * y + z * z + _SAFE)
        yaw = xp.arctan2(y, x + _SAFE)
        pitch = xp.arctan2(-z, xp.sqrt(x * x + y * y + _SAFE))
        return xp.stack([r, yaw, pitch], axis=-1)

    @classmethod
    def residual(cls, pred, z):
        d = pred - z
        return jnp.concatenate(
            [d[..., :1], wrap_angle(d[..., 1:3])], axis=-1
        )

    @staticmethod
    def inverse(z, calib=None):
        xp = _xp(z)
        r, yaw, pitch = z[..., 0], z[..., 1], z[..., 2]
        cp = xp.cos(pitch)
        return xp.stack(
            [r * cp * xp.cos(yaw), r * cp * xp.sin(yaw), -r * xp.sin(pitch)],
            axis=-1,
        )


class MonocularCamera(_PointObs):
    """Pinhole projection, obs = (u, v).  Camera looks along +z.

    No single-view inverse model exists (depth unobservable).  Landmark
    initialization comes from either (a) a caller-supplied
    ``init_rel_pos`` — the reference's contract, where monocular landmarks
    are seeded with an explicit ``unknown_rel_pos_init`` — or (b) the
    engine's deferred two-view triangulation front-end
    (``SrbaParams.mono_min_parallax_deg``, on by default), which buffers
    initless sightings (``add_observation`` returns -1 while pending) and
    materializes the landmark once parallax suffices.
    """

    name = "MonocularCamera"
    obs_dim = 2
    lm_dim = 3
    pose_group = SE3
    has_inverse_model = False
    default_depth = 3.0

    @staticmethod
    def h(lm_in_sensor, calib: CameraCalib):
        xp = _xp(lm_in_sensor)
        zc = lm_in_sensor[..., 2]
        inv_z = 1.0 / xp.maximum(zc, 1e-4)
        u = calib.cx + calib.fx * lm_in_sensor[..., 0] * inv_z
        v = calib.cy + calib.fy * lm_in_sensor[..., 1] * inv_z
        return xp.stack([u, v], axis=-1)

    @classmethod
    def inverse(cls, z, calib: CameraCalib, depth=None):
        xp = _xp(z)
        d = cls.default_depth if depth is None else depth
        x = (z[..., 0] - calib.cx) / calib.fx * d
        y = (z[..., 1] - calib.cy) / calib.fy * d
        return xp.stack(
            [x, y, xp.broadcast_to(xp.asarray(d, dtype=z.dtype), x.shape)],
            axis=-1)


class StereoCamera(_PointObs):
    """Rectified stereo pair, obs = (ul, vl, ur, vr); right camera at
    (+baseline, 0, 0) in the left-camera (sensor) frame."""

    name = "StereoCamera"
    obs_dim = 4
    lm_dim = 3
    pose_group = SE3

    @staticmethod
    def h(lm_in_sensor, calib: StereoCalib):
        xp = _xp(lm_in_sensor)
        x, y, zc = (lm_in_sensor[..., 0], lm_in_sensor[..., 1],
                    lm_in_sensor[..., 2])
        inv_z = 1.0 / xp.maximum(zc, 1e-4)
        ul = calib.cx + calib.fx * x * inv_z
        vl = calib.cy + calib.fy * y * inv_z
        ur = calib.cx + calib.fx * (x - calib.baseline) * inv_z
        vr = vl
        return xp.stack([ul, vl, ur, vr], axis=-1)

    @staticmethod
    def inverse(z, calib: StereoCalib):
        xp = _xp(z)
        disparity = xp.maximum(z[..., 0] - z[..., 2], 1e-3)
        depth = calib.fx * calib.baseline / disparity
        x = (z[..., 0] - calib.cx) / calib.fx * depth
        y = (z[..., 1] - calib.cy) / calib.fy * depth
        return xp.stack([x, y, depth], axis=-1)


class RGBDCamera(_PointObs):
    """RGB-D camera: pinhole pixel + metric depth, obs = (u, v, d) with the
    camera looking along +z.  Not in the reference's model set (its eight
    types stop at stereo; ``include/srba/models/observations.h``, public
    MRPT/srba layout) — added here because depth cameras are the modern
    indoor default and BASELINE.json's north star names RGB-D residuals
    explicitly.  The depth channel makes the inverse sensor model exact, so
    RGB-D landmarks need no external triangulation front-end and loop
    closures bootstrap through the closed-form Kabsch path
    (engine/closure.py)."""

    name = "RGBDCamera"
    obs_dim = 3
    lm_dim = 3
    pose_group = SE3

    @staticmethod
    def h(lm_in_sensor, calib: CameraCalib):
        xp = _xp(lm_in_sensor)
        zc = lm_in_sensor[..., 2]
        inv_z = 1.0 / xp.maximum(zc, 1e-4)
        u = calib.cx + calib.fx * lm_in_sensor[..., 0] * inv_z
        v = calib.cy + calib.fy * lm_in_sensor[..., 1] * inv_z
        return xp.stack([u, v, zc], axis=-1)

    @staticmethod
    def inverse(z, calib: CameraCalib):
        xp = _xp(z)
        d = z[..., 2]
        x = (z[..., 0] - calib.cx) / calib.fx * d
        y = (z[..., 1] - calib.cy) / calib.fy * d
        return xp.stack([x, y, d], axis=-1)


class RelativePoses2D:
    """Graph-SLAM mode: the 'landmark' is another keyframe's relative SE(2)
    pose; the observation is a measured relative pose (x, y, yaw).  No Schur
    marginalization applies (there are no point landmarks)."""

    name = "RelativePoses2D"
    obs_dim = 3   # residual dimension
    z_dim = 3     # stored measurement width (SE2 pose storage)
    lm_dim = 3    # landmark state is an SE2 pose
    pose_group = SE2
    has_inverse_model = True
    is_pose_landmark = True

    @staticmethod
    def h(lm_pose_in_obs_frame, calib=None):
        return lm_pose_in_obs_frame

    @classmethod
    def residual(cls, pred, z):
        return SE2.local_err(z, pred)

    @staticmethod
    def inverse(z, calib=None):
        return z


class RelativePoses3D:
    """Graph-SLAM mode in SE(3); observation = pseudo-log relative pose (6)."""

    name = "RelativePoses3D"
    obs_dim = 6   # residual dimension (tangent)
    z_dim = 7     # stored measurement width (SE3 pose storage)
    lm_dim = 7    # SE3 pose storage
    pose_group = SE3
    has_inverse_model = True
    is_pose_landmark = True

    @staticmethod
    def h(lm_pose_in_obs_frame, calib=None):
        return lm_pose_in_obs_frame  # full SE3 pose; residual maps to tangent

    @classmethod
    def residual(cls, pred, z):
        # pred is a 7-d pose, z a 7-d measured pose; residual in the tangent.
        return SE3.local_err(z, pred)

    @staticmethod
    def inverse(z, calib=None):
        return z


for _m in [Cartesian2D, Cartesian3D, RangeBearing2D, RangeBearing3D,
           MonocularCamera, StereoCamera, RGBDCamera]:
    _m.z_dim = _m.obs_dim

OBSERVATION_MODELS = {
    m.name: m
    for m in [
        Cartesian2D, Cartesian3D, RangeBearing2D, RangeBearing3D,
        MonocularCamera, StereoCamera, RGBDCamera,
        RelativePoses2D, RelativePoses3D,
    ]
}
