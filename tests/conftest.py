"""Test config: the tests run on the CPU with 8 virtual devices (sharding
tests run without multi-chip hardware, SURVEY.md section 4) and f64
enabled for parity with the Rust reference's FloatGeneric<f64> tests.

``JAX_PLATFORMS=cpu`` is set unless the caller set it, so JAX never
initializes a GPU here; the default device is pinned to the CPU as well, so
tests marked ``gpu`` (run with ``JAX_PLATFORMS=cuda,cpu``) place their
work on the card explicitly. Whether a card is present is decided inside
those tests' fixtures, never at import time."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.devices("cpu")[0])


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound per-process compiled-program accumulation: with the full
    suite in one process (~300 jitted programs) the XLA CPU compiler
    segfaulted reproducibly near the end of the run (r5; crash inside
    backend_compile_and_load, test-order dependent, never in isolation).
    Dropping executable caches between modules keeps the compiler's
    working set flat; modules recompile their own programs anyway."""
    yield
    import jax
    jax.clear_caches()
