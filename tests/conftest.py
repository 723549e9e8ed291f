"""Test configuration: run on CPU with 8 virtual devices so multi-device
sharding paths (parallel/) are exercised without accelerator hardware —
the rebuild's analogue of the reference's untested-but-correct MPI paths
(SURVEY.md §4).

JAX_PLATFORMS, when set, decides the platform; otherwise the CPU is
pinned here. Tests marked `gpu` need a card and skip without one: run
them on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_devices():
    """The GPU devices; skips the test when the default device is not a
    GPU. Decided here, at run time, so every worker collects the same
    tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return devices
