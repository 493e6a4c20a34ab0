import importlib.util
import os

# Tests run on the CPU backend with 8 virtual devices (sharding and
# collectives without hardware) unless JAX_PLATFORMS names another platform:
# `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` runs the tests that
# need a GPU on the card.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

# the DOGE modules import flax at module level; a machine without flax (the
# GPU machine need not have it) collects every other test module
collect_ignore = (
    [] if importlib.util.find_spec("flax")
    else ["test_learn.py", "test_data_pipeline.py"]
)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, so every
    test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
