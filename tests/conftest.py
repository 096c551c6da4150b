"""Test environment: the CPU backend (unless JAX_PLATFORMS names another)
with 8 virtual devices, so the sharded paths run without accelerators.
Must run before jax imports anywhere.

Tests marked `gpu` compile for the card: they skip elsewhere, and run on
a GPU host with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: compiles for an NVIDIA GPU; skips on other backends")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu` tests when JAX has no GPU. Decided per test, never at
    import, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU: jax.default_backend() is "
                        f"{jax.default_backend()!r}")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
