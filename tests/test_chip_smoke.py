"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and its
phase functions pass at small sizes (the CPU stands in for the card; the
GPU-vs-CPU comparisons then compare the CPU with itself)."""

import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_exits_nonzero_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"] + args, env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_exits_nonzero_alone(tmp_path):
    """Without the rest of the repository it fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_window_small():
    chip_smoke.phase_window(bucket=(4, 32, 128))


def test_phase_spd_inverse_small():
    timings = chip_smoke.phase_spd_inverse(shapes=((256, 6), (100, 3)))
    assert [t["shape"] for t in timings] == [[256, 6, 6], [100, 3, 3]]
    assert all(t["max_rel_err"] <= chip_smoke.SPD_RTOL for t in timings)


def test_phase_pgo_small():
    rec = chip_smoke.phase_pgo(K=2000)
    assert rec["config"] == "pgo2k" and rec["converged"] == 1.0


def test_match_check_rejects_divergent_states():
    import numpy as np
    info = {"err_final": np.float32(1.0), "iters": np.int32(3)}
    ref = (np.zeros((2, 7)), np.zeros((3, 3)), info)
    out = (np.full((2, 7), 2 * chip_smoke.STATE_ATOL), np.zeros((3, 3)), info)
    chip_smoke._check_solve_match("same", ref, ref)
    with pytest.raises(AssertionError):
        chip_smoke._check_solve_match("diverged", out, ref)
    bad = dict(info, err_final=np.float32(1.01))
    with pytest.raises(AssertionError):
        chip_smoke._check_solve_match("err", (ref[0], ref[1], bad), ref)


def test_fresh_compiles_skip_the_persistent_cache():
    """Inside ``_fresh_compiles`` nothing is written to (or read from) the
    persistent cache; after it, caching resumes."""
    import jax
    import jax.numpy as jnp

    cache = os.environ["JAX_COMPILATION_CACHE_DIR"]

    def entries():
        return len(os.listdir(cache)) if os.path.isdir(cache) else 0

    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    try:
        x = jnp.arange(5.0)
        before = entries()
        with chip_smoke._fresh_compiles():
            jax.jit(lambda v: jnp.cos(v) * 7.25 - 0.5)(x).block_until_ready()
        assert entries() == before
        jax.jit(lambda v: jnp.cos(v) * 9.75 - 0.5)(x).block_until_ready()
        assert entries() > before
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old)
