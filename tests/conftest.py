"""Test harness config.

Tests run on CPU with an 8-device fake mesh (the survey's recommended
pattern for multi-device testing without hardware, SURVEY.md §4) and with
x64 enabled so float64/complex128 parity cases match the reference's C++
doubles. ``JAX_PLATFORMS`` picks another backend when set. Tests marked
``gpu`` need the card and skip elsewhere (``gpu`` fixture).
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from pcsc_eigenvalue_solver_project_tpu.utils.compile_cache import (  # noqa: E402
    use_checkout_cache)

# The suite is compile-bound (hundreds of distinct jit signatures); re-runs
# hit the persistent cache instead of XLA.
use_checkout_cache(_ROOT)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.key(42)


@pytest.fixture
def gpu():
    """The first device, if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev
