"""Test configuration.

The suite runs on the CPU backend with eight virtual devices
(``XLA_FLAGS``), so the multi-device sharding paths run without a card —
the way the reference validates its distributed path with an in-process
cluster (``/root/reference/dask_array/tests/conftest.py:42-63``).

``DA_TEST_PLATFORM=gpu`` leaves the platform choice to JAX, so the card
is the default device; tests marked ``gpu`` need one, and the
``gpu_device`` fixture skips them without it:

    DA_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import os

if os.environ.get("DA_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

# second-execution-backend lane (the reference's --scheduler=dask/frisky/both
# discipline, conftest.py:42-63): DA_TPU_MODE=eager re-runs the whole suite
# through the eager per-value executor instead of the compiled trace
if os.environ.get("DA_TPU_MODE") == "eager":
    from dask_array_tpu import config as _config

    _config.set_global({"tpu.jit": False})


def pytest_collection_modifyitems(config, items):
    if os.environ.get("DA_TPU_MODE") != "eager":
        return
    import pytest as _pytest

    skip = _pytest.mark.skip(
        reason="optimizer-structure test: identical in the eager lane "
        "(and hypothesis x eager per-value execution is minutes per case)"
    )
    for item in items:
        if "test_fuzz_optimize" in item.nodeid:
            item.add_marker(skip)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with DA_TEST_PLATFORM=gpu on a machine with one)")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def mesh8():
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices("cpu")[:8]).reshape(2, 4)
    return Mesh(devs, ("x", "y"))
