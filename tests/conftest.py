"""Test configuration: run everything on CPU with 8 virtual devices.

Sharding/collective tests run against a virtual 8-device CPU mesh; the
GPU kernels run in Pallas interpret mode. Tests that need a GPU carry the
``chip`` marker and skip here (the ``chip`` fixture decides at run time);
``python chip_smoke.py`` runs the same checks on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# the repository's one compile-cache rule (votenet_tpu/utils/compile_cache.py)
from votenet_tpu.utils.compile_cache import ENV_VAR, compile_cache_dir  # noqa: E402

os.environ[ENV_VAR] = compile_cache_dir()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def chip():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on the card")
