"""Test harness: run JAX on CPU with 8 virtual devices so sharding tests
work without accelerator hardware. Pallas kernels run in interpret mode,
passed explicitly by each test.

Tests marked `gpu` need a card. They skip elsewhere; the `gpu_device`
fixture decides at run time. On a machine with one, run them with
`CFEAR_GPU_TESTS=1 python -m pytest tests -m gpu`: the harness then keeps
the CUDA backend (and the CPU one for references).

The platform is also forced through jax.config, in case JAX was imported
before this file ran.
"""

import os

import pytest

_PLATFORMS = "cuda,cpu" if os.environ.get("CFEAR_GPU_TESTS") else "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (set CFEAR_GPU_TESTS=1 on one)")
