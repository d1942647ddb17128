"""Test configuration: run everything on CPU with 8 virtual devices.

Sharding logic (shard_map / psum over the scenario and sample mesh axes) is
validated here without accelerator hardware, per SURVEY.md section 5 item 3.
The backend is not initialized until first use, so forcing the platform via
``jax.config.update`` here works even if jax was imported earlier.

Tests marked ``gpu`` need the card and skip elsewhere (the ``gpu`` fixture
decides). On a machine with a GPU, run them with

    ERGODIC_TESTS_ON_GPU=1 python -m pytest tests -m gpu

which leaves JAX on its default (GPU) platform.
"""

import os

import pytest

ON_GPU = os.environ.get("ERGODIC_TESTS_ON_GPU") == "1"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        # XLA_FLAGS is read at backend *initialization*, which has not
        # happened yet even if jax is already imported.
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compile cache: the suite is scan/jit heavy and CPU compiles
# dominate wall time on re-runs otherwise. JAX_COMPILATION_CACHE_DIR, when
# set, already names the cache and is left alone.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(__file__), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with ERGODIC_TESTS_ON_GPU=1 on the card")
    return jax.devices()[0]
