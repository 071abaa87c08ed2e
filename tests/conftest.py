"""Test configuration.

Tests run on a virtual 8-device CPU mesh so that every sharding /
collective code path is exercised without accelerator hardware, per
the multi-device test strategy the reference lacks (SURVEY.md
section 4).  Environment must be set before jax is first imported.

Tests marked ``gpu`` need the card; they skip from the ``gpu``
fixture unless JAX_PLATFORMS names it (README, "Hardware tests").
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    # Host-side golden tests compare against float64 oracles.
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The card, for tests of compiled GPU kernels; skips without one."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu")
    return jax.devices()[0]
