"""The solver's pytree dataclasses (``WindowBatch``, ``CameraCalib``,
``StereoCalib``): frozen ``dataclasses`` registered with
``jax.tree_util.register_dataclass``.  They must flatten/unflatten with
``None`` optional fields, survive ``jit`` and ``shard_map``, and keep
their field values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from srba_tpu.models.observations import CameraCalib, StereoCalib
from srba_tpu.solver.lm import WindowBatch


def _batch(N=8, **optional):
    return WindowBatch(
        edge_pose=jnp.zeros((2, 7)), edge_opt=jnp.ones(2),
        lm_state=jnp.zeros((3, 3)), lm_opt=jnp.ones(3),
        obs_z=jnp.arange(N * 4, dtype=jnp.float32).reshape(N, 4),
        obs_lm=jnp.zeros(N, jnp.int32),
        path_edge=jnp.zeros((N, 2), jnp.int32),
        path_sign=jnp.zeros((N, 2)), obs_valid=jnp.ones(N),
        whitener=jnp.eye(4), sensor_pose_inv=jnp.zeros(7),
        **optional)


@pytest.mark.parametrize("optional", [
    {},
    {"calib": StereoCalib.make()},
    {"calib": CameraCalib.make(), "iters_cap": jnp.asarray(3, jnp.int32)},
    {"edge_prior": jnp.zeros((2, 7)), "edge_prior_w": jnp.ones(2)},
])
def test_window_batch_flatten_roundtrip(optional):
    b = _batch(**optional)
    leaves, treedef = jax.tree.flatten(b)
    # None optionals contribute no leaves; present ones do.
    n_calib = len(jax.tree.leaves(optional.get("calib")))
    n_opt = sum(1 for k, v in optional.items() if k != "calib")
    assert len(leaves) == 11 + n_calib + n_opt
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, WindowBatch)
    for f in dataclasses.fields(WindowBatch):
        a, c = getattr(b, f.name), getattr(back, f.name)
        if a is None:
            assert c is None, f.name
        else:
            jax.tree.map(np.testing.assert_array_equal, a, c)


def test_dataclasses_are_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        CameraCalib.make().fx = 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        _batch().obs_z = None


def test_calib_make_keeps_host_numpy_leaves():
    c = StereoCalib.make(fx=300.0, baseline=0.5)
    assert all(isinstance(x, np.ndarray) for x in jax.tree.leaves(c))
    assert float(c.fx) == 300.0 and float(c.baseline) == 0.5
    assert [f.name for f in dataclasses.fields(c)] == [
        "fx", "fy", "cx", "cy", "baseline"]


def test_window_batch_through_jit():
    b = _batch(calib=CameraCalib.make(fx=2.0))

    @jax.jit
    def f(batch):
        out = dataclasses.replace(batch, obs_z=batch.obs_z * batch.calib.fx)
        return out, jnp.sum(out.obs_z)

    out, total = f(b)
    assert isinstance(out, WindowBatch) and out.edge_prior is None
    np.testing.assert_allclose(np.asarray(out.obs_z),
                               2.0 * np.asarray(b.obs_z))
    assert float(total) == pytest.approx(2.0 * float(jnp.sum(b.obs_z)))


def test_window_batch_through_shard_map():
    from srba_tpu.parallel.sharding import _batch_specs, make_mesh

    n = min(4, len(jax.devices()))
    mesh = make_mesh(n)
    b = _batch(N=4 * n, calib=StereoCalib.make())
    specs = _batch_specs(b)

    def local_sum(batch):
        return jax.lax.psum(jnp.sum(batch.obs_z * batch.obs_valid[:, None]),
                            "obs")

    total = jax.jit(jax.shard_map(local_sum, mesh=mesh, in_specs=(specs,),
                                  out_specs=P(), check_vma=False))(b)
    assert float(total) == pytest.approx(float(jnp.sum(b.obs_z)))
