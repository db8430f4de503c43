"""Batched small-block SPD inverse: the unrolled-jnp form vs
``jnp.linalg.inv`` ground truth (all dims used by the solvers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srba_tpu.ops.block_linalg import spd_inverse, spd_inverse_unrolled


def _spd_stack(B, d, seed=0, cond=5.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d)).astype(np.float32)
    return jnp.asarray(A @ A.transpose(0, 2, 1)
                       + cond * np.eye(d, dtype=np.float32))


@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("B", [1, 7, 300])
def test_unrolled_matches_linalg(B, d):
    M = _spd_stack(B, d)
    ref = jnp.linalg.inv(M)
    out = spd_inverse_unrolled(M)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_default_dispatch_is_correct():
    M = _spd_stack(4096, 6, seed=2)
    ref = jnp.linalg.inv(M)
    np.testing.assert_allclose(np.asarray(spd_inverse(M)), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_leading_batch_dims():
    M = _spd_stack(12, 3, seed=3).reshape(3, 4, 3, 3)
    ref = jnp.linalg.inv(M)
    out = spd_inverse_unrolled(M)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_grad_flows_through_unrolled():
    M = _spd_stack(8, 3, seed=4)

    def loss(M):
        return jnp.sum(spd_inverse_unrolled(M) ** 2)

    g = jax.grad(loss)(M)
    assert np.isfinite(np.asarray(g)).all()
