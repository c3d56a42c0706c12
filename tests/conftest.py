"""Test harness config: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; all sharding logic is validated on an 8-device
CPU mesh per the multi-host test strategy in SURVEY.md section 4. What
needs the GPU is checked by chip_smoke.py. The platform is set through
jax.config before any backend initializes.
"""

import os

# Cache every XLA compile; CPU compiles are slow.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.0")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax
import pytest

from tracer.utils import compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
compile_cache.enable()


@pytest.fixture(autouse=True, scope="module")
def _release_jit_state_between_modules():
    """Free compiled executables after each test module.

    The full suite deterministically SEGFAULTS inside XLA:CPU's
    backend_compile_and_load (LLVM JIT) at tests/test_io.py::
    test_driver_png_frames_written once enough compiled programs have
    accumulated across the preceding nine modules (reproduced twice at
    the same test, 2026-08-20; any subset of the modules passes). Not a
    tracer bug — an XLA:CPU JIT-state failure under accumulation — but
    CI must survive it: dropping executable references module-by-module
    keeps the live JIT footprint bounded. The on-disk compilation cache
    (set above) makes the forced recompiles cheap."""
    yield
    jax.clear_caches()
