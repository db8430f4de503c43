"""The persistent compile-cache helper: ``JAX_COMPILATION_CACHE_DIR`` wins
when set, otherwise a fixed ``<repo>/.jax_cache`` (or the caller's
fallback) that does not move between processes."""

import os
import subprocess
import sys

import pytest

from srba_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Compiles one tiny program with the threshold at zero so it is cached.
_PROBE = """
import sys
import jax, jax.numpy as jnp
from srba_tpu.utils.compile_cache import cache_dir, enable_compile_cache
fallback = sys.argv[1] if len(sys.argv) > 1 else None
path = enable_compile_cache(fallback)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir=None, fallback=None):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE] + ([str(fallback)] if fallback else []),
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-2:]


def test_env_var_is_honoured(tmp_path):
    env_dir, fallback = tmp_path / "from_env", tmp_path / "fallback"
    path, configured = _probe(env_dir=env_dir, fallback=fallback)
    assert path == configured == str(env_dir)
    assert any(env_dir.iterdir()), "no cache entry written to the env dir"
    assert not fallback.exists()


def test_fallback_dir_used_when_env_unset(tmp_path):
    fallback = tmp_path / "fallback"
    path, configured = _probe(fallback=fallback)
    assert path == configured == str(fallback)
    assert any(fallback.iterdir())


def test_default_path_is_fixed_repo_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    # Same answer in another process: nothing keyed by pid or time.
    out = subprocess.run(
        [sys.executable, "-c", "from srba_tpu.utils.compile_cache import "
         "cache_dir; print(cache_dir())"],
        env={**{k: v for k, v in os.environ.items()
                if k != compile_cache.ENV_VAR}, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.stdout.strip() == compile_cache.cache_dir()


@pytest.mark.parametrize("fallback", [None, "/some/cli/dir"])
def test_env_var_beats_fallback(monkeypatch, fallback):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/from/env")
    assert compile_cache.cache_dir(fallback) == "/from/env"


def test_cli_flag_applies_only_without_env(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir("/cli/flag") == "/cli/flag"


def test_tests_keep_out_of_the_repo_cache():
    """The test processes cache in a directory of their own
    (``tests/conftest.py``), never in ``<repo>/.jax_cache``."""
    import tempfile
    d = os.environ[compile_cache.ENV_VAR]
    assert d != compile_cache.REPO_CACHE_DIR
    assert os.path.commonpath([d, tempfile.gettempdir()]) == \
        tempfile.gettempdir()
