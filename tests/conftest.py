"""Test configuration: virtual 8-device CPU mesh + fp64 enabled.

Tests run on CPU with ``xla_force_host_platform_device_count=8`` so the
multi-device sharding path is exercised without a cluster (SURVEY.md SS4),
and with x64 enabled so adjoint identities can be verified to ~1e-12 in
complex128 (the solver itself runs in fp32; the fp32 tolerances are tested
separately). Checks that need a GPU are phases of ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Pin the CPU platform even where the environment selects another one
# (a config update wins until the first backend query).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def rng():
    return jax.random.PRNGKey(42)
