"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding is validated the way the reference validates multi-FPGA
behavior offline (udpreplay, udp/README.md) — without hardware: JAX's host
platform is split into 8 virtual devices so ``shard_map`` collectives run
for real.

Tests that need the GPU carry the ``gpu`` marker and skip here with a
reason; the card itself is exercised by ``chip_smoke.py``.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin the platform in the config as well (must happen before any
# computation), and keep test processes from writing a persistent compile
# cache: entry points the tests call point it at the checkout.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other platforms"
    )


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_gpu(request):
    if request.node.get_closest_marker("gpu") is not None:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU; JAX runs on {platform}")
