"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device shardings are validated here on 8 virtual CPU devices; the
tests marked ``gpu`` need the card, skip here (the ``gpu`` fixture decides,
never an import-time check), and run on the card through phase (f) of
chip_smoke.py.

The CPU platform is forced *before* any backend initialization so the
suite stays hermetic.  Once a backend is initialized the update has no
effect: chip_smoke.py runs the gpu-marked tests in its own process, whose
backend is already the GPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card by chip_smoke.py (phase f)")
    return jax.devices()[0]
