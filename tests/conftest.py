"""Test configuration: run everything on a virtual 8-device CPU mesh so that
multi-device sharding paths are exercised without accelerator hardware
(SURVEY.md §5, "multi-host tests runnable without a pod").  Must set env
vars before the first ``import jax`` anywhere in the test process.

Entry points under test (the CLI, ``chip_smoke`` phases) turn on the
persistent compile cache; each test process points it at a directory of its
own, removed at exit, so tests never read or write the repository's
``.jax_cache`` or a cache shared with other hosts.
"""

import atexit
import os
import shutil
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_cache = tempfile.mkdtemp(prefix="srba_jax_cache_")
os.environ["JAX_COMPILATION_CACHE_DIR"] = _cache
atexit.register(shutil.rmtree, _cache, ignore_errors=True)
