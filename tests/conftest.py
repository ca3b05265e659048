"""Test configuration: JAX's CPU backend with 8 virtual devices.

Multi-device sharding paths run on an emulated 8-device CPU mesh (the
reference has no distributed tests at all — see SURVEY.md §4). Tests marked
``gpu`` need an NVIDIA GPU and skip elsewhere; on the card run them with
``ANEMOI_TEST_DEVICE=gpu python -m pytest -m gpu tests/``, which leaves
JAX on its default (GPU) backend.
"""

import os
import sys

ON_GPU = os.environ.get("ANEMOI_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() == 8, jax.devices()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_graph():
    from helpers_models import small_graph_cached

    return small_graph_cached()


@pytest.fixture
def gpu():
    """The GPU device, or a skip where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with ANEMOI_TEST_DEVICE=gpu on the card)")
    return jax.devices()[0]
