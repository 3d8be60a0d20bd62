"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's "same test body, CPU or GPU backend" strategy
(reference ``tests/test_common.hpp:66-89``): the jnp CPU execution acts as
the reference backend.

``SPLA_TEST_GPU=1`` leaves the platform to JAX instead, so the tests
marked ``gpu`` (``tests/test_gpu.py``) run on the card:

    SPLA_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu -q

Unset, those tests skip with a reason.
"""

import os

GPU_LANE = bool(os.environ.get("SPLA_TEST_GPU"))

if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)
