"""Test configuration: force CPU with 8 virtual devices for sharding tests.

All sharding/collective paths are validated on a virtual 8-device CPU mesh.
Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; chip_smoke.py
runs their checks on the card.  Must run before jax imports.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the config update is authoritative (must happen before the backend is
# initialized)
jax.config.update("jax_platforms", "cpu")
# the tool mains turn on the persistent compilation cache; test processes
# stay off it
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    # decided per test, never at import: every xdist worker must collect
    # the same tests
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this check "
                    "on the card)")


@pytest.fixture(scope="session")
def tiny_model():
    from avatar_tpu.testing import synthetic_model

    return synthetic_model(detail=1)


@pytest.fixture()
def rng():
    # function-scoped: a shared session rng makes test inputs depend on
    # execution order (observed flake in test_exp_log_roundtrip)
    return np.random.default_rng(42)
