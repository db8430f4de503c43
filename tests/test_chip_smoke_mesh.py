"""``chip_smoke.py`` phases that drive the CLI and the mesh paths, at small
sizes on the virtual 8-device CPU mesh (``tests/conftest.py``).  A CPU
trace has no GPU planes, so the mesh phases run here without their
ran-on-n-GPUs check; the check itself is tested to find no GPU here."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke


@pytest.fixture
def no_gpu_check(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_on_gpus", lambda name, n, f: f())


def test_phase_cli_and_refine_map_small():
    chip_smoke.phase_cli(num_kfs=40, refine_kfs=40)


def test_four_window_small(no_gpu_check):
    chip_smoke.four_window(n=4, bucket=(4, 32, 128))


def test_four_refine_map_small(no_gpu_check):
    chip_smoke.four_refine_map(n=4, K=40)


def test_trace_of_a_cpu_run_names_no_gpu():
    out, ran = chip_smoke._gpus_that_ran(lambda: jnp.arange(4.0) * 2)
    np.testing.assert_array_equal(np.asarray(out), [0.0, 2.0, 4.0, 6.0])
    assert ran == []


def test_mesh_check_fails_without_the_gpus():
    with pytest.raises(AssertionError):
        chip_smoke._on_gpus("cpu", 4, lambda: jnp.ones(3))
