"""Observation-model tests: h/inverse roundtrips, residual semantics, and
AD-Jacobian vs finite-difference cross-checks — the batched analog of the
reference's debug-mode analytic-vs-numeric Jacobian verification
(SURVEY.md §5, "Jacobian correctness")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srba_tpu.models.observations import (
    OBSERVATION_MODELS, CameraCalib, RGBDCamera, StereoCalib,
    Cartesian2D, Cartesian3D, MonocularCamera, RangeBearing2D, RangeBearing3D,
    RelativePoses2D, RelativePoses3D, StereoCamera,
)
from srba_tpu.ops.robust import pseudo_huber_cost, pseudo_huber_weight

KEY = jax.random.PRNGKey(7)

CALIBS = {
    "MonocularCamera": CameraCalib.make(),
    "StereoCamera": StereoCalib.make(),
    "RGBDCamera": CameraCalib.make(),
}

POINT_MODELS = [Cartesian2D, Cartesian3D, RangeBearing2D, RangeBearing3D,
                MonocularCamera, StereoCamera, RGBDCamera]


def _sample_points(model, n=32):
    """Sensor-frame landmark samples in the model's valid domain."""
    pts = jax.random.normal(KEY, (n, model.lm_dim)) * 2.0
    if model in (MonocularCamera, StereoCamera, RGBDCamera):
        # Keep points well in front of the camera.
        pts = pts.at[:, 2].set(jnp.abs(pts[:, 2]) + 1.0)
    else:
        # Keep away from the range singularity at the origin.
        pts = pts + jnp.sign(pts) * 0.1
    return pts


@pytest.mark.parametrize("model", POINT_MODELS, ids=lambda m: m.name)
def test_h_shapes_and_batching(model):
    calib = CALIBS.get(model.name)
    pts = _sample_points(model)
    z = model.h(pts, calib)
    assert z.shape == (32, model.obs_dim)
    # Single-sample call agrees with batched call.
    z0 = model.h(pts[0], calib)
    np.testing.assert_allclose(z0, z[0], atol=1e-6)


@pytest.mark.parametrize(
    "model",
    [m for m in POINT_MODELS if m.has_inverse_model],
    ids=lambda m: m.name,
)
def test_inverse_sensor_model_roundtrip(model):
    """h(inverse(z)) == z — landmark init consistency (reference
    ``inverse_sensor_model``)."""
    calib = CALIBS.get(model.name)
    pts = _sample_points(model)
    z = model.h(pts, calib)
    pts2 = model.inverse(z, calib)
    np.testing.assert_allclose(pts2, pts, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(model.h(pts2, calib), z, atol=1e-3, rtol=1e-4)


def test_mono_inverse_uses_assumed_depth():
    calib = CALIBS["MonocularCamera"]
    z = jnp.asarray([[160.0, 120.0]])
    pt = MonocularCamera.inverse(z, calib, depth=5.0)
    np.testing.assert_allclose(pt, [[0.0, 0.0, 5.0]], atol=1e-5)


@pytest.mark.parametrize("model", POINT_MODELS, ids=lambda m: m.name)
def test_jacobian_vs_finite_difference(model):
    """jacfwd of h matches central finite differences (the reference's
    analytic-vs-numeric debug check, here validating the AD path)."""
    calib = CALIBS.get(model.name)
    pts = np.asarray(_sample_points(model, n=8), dtype=np.float64)

    def h_np(p):
        return np.asarray(model.h(jnp.asarray(p, jnp.float32), calib),
                          dtype=np.float64)

    jac_ad = jax.vmap(jax.jacfwd(lambda p: model.h(p, calib)))(
        jnp.asarray(pts, jnp.float32)
    )
    eps = 1e-3
    for b in range(pts.shape[0]):
        jac_fd = np.zeros((model.obs_dim, model.lm_dim))
        for j in range(model.lm_dim):
            dp = np.zeros(model.lm_dim)
            dp[j] = eps
            jac_fd[:, j] = (h_np(pts[b] + dp) - h_np(pts[b] - dp)) / (2 * eps)
        np.testing.assert_allclose(
            np.asarray(jac_ad[b], np.float64), jac_fd, atol=5e-2, rtol=5e-2
        )


def test_range_bearing_residual_wraps_angle():
    pred = jnp.asarray([[1.0, 3.1]])
    z = jnp.asarray([[1.0, -3.1]])
    r = RangeBearing2D.residual(pred, z)
    assert abs(float(r[0, 1])) < 0.2  # wrapped, not ~6.2


def test_stereo_disparity_sign():
    calib = CALIBS["StereoCamera"]
    pt = jnp.asarray([[0.5, 0.1, 4.0]])
    z = StereoCamera.h(pt, calib)
    assert float(z[0, 0]) > float(z[0, 2])  # ul > ur for points ahead
    assert abs(float(z[0, 1]) - float(z[0, 3])) < 1e-5  # rectified: vl == vr


@pytest.mark.parametrize("model", [RelativePoses2D, RelativePoses3D],
                         ids=lambda m: m.name)
def test_relative_pose_residual(model):
    group = model.pose_group
    poses = group.rand(KEY, 8)
    r = model.residual(poses, poses)
    assert r.shape == (8, model.obs_dim)
    np.testing.assert_allclose(r, 0.0, atol=2e-5)
    # Perturbed pose gives nonzero residual of the perturbation's magnitude.
    delta = jnp.ones((8, group.dof)) * 0.01
    r2 = model.residual(group.retract(poses, delta), poses)
    assert float(jnp.abs(r2).max()) > 1e-3


def test_registry_complete():
    assert set(OBSERVATION_MODELS) == {
        "Cartesian2D", "Cartesian3D", "RangeBearing2D", "RangeBearing3D",
        "MonocularCamera", "StereoCamera", "RGBDCamera",
        "RelativePoses2D", "RelativePoses3D",
    }
    for m in OBSERVATION_MODELS.values():
        assert m.z_dim >= m.obs_dim


def test_pseudo_huber():
    s = jnp.asarray([0.0, 1.0, 100.0])
    w = pseudo_huber_weight(s, 1.0)
    assert float(w[0]) == pytest.approx(1.0)
    assert float(w[2]) < float(w[1]) < float(w[0])
    c = pseudo_huber_cost(s, 1.0)
    assert float(c[0]) == pytest.approx(0.0, abs=1e-6)
    # Near-quadratic for small s, sub-linear growth for large s.
    assert float(c[1]) == pytest.approx(2.0 * (np.sqrt(2.0) - 1.0), abs=1e-5)
    assert float(c[2]) < s[2]
