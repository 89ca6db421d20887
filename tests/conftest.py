"""Test harness config: force an 8-device virtual CPU mesh (SURVEY.md §5.3)
so sharding/collective paths run without accelerator hardware. The
platform is pinned through ``jax.config`` as well as ``JAX_PLATFORMS`` so
a bare ``pytest`` on a GPU machine still tests the CPU paths.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.2")

import jax

jax.config.update("jax_platforms", "cpu")

from lhvi_tpu.utils.cache import enable_compile_cache

# persistent compile cache: repeat test runs skip XLA recompiles
enable_compile_cache()

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after every test module.

    The XLA CPU client segfaults (inside ``backend_compile_and_load``)
    once a single process accumulates roughly 230+ tests' worth of live
    compiled programs — observed reproducibly in round 5 at whatever
    test happened to compile next, independent of that test's content.
    Clearing per module keeps the live-executable count bounded; the
    persistent on-disk compile cache makes the re-traces cheap."""
    yield
    jax.clear_caches()
