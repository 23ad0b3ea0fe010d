"""Test harness: the JAX CPU backend with 8 virtual devices.

Multi-device hardware is not available in CI; the standard JAX answer is a
fake device mesh on CPU (SURVEY.md §4d).  The suite runs on the CPU unless
JAX_PLATFORMS names another platform: tests marked `gpu` need the card and
run there with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"

import jax

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_mesh():
    if ON_CPU:
        devices = jax.devices()
        assert devices[0].platform == "cpu", devices
        assert len(devices) == 8, devices
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)
