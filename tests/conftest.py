"""Test config: the tests run on the CPU with 8 virtual devices.

`JAX_PLATFORMS=cpu` is set before JAX is imported (and asserted after), so
the suite never touches an accelerator; sharding tests run on a virtual
8-device CPU mesh (SURVEY §4) from the XLA flag below, and the Pallas
kernels run in interpret mode. The GPU path is exercised by
`python chip_smoke.py` (one card) and `python chip_smoke.py --multi`
(four cards) on a machine with GPUs.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)
