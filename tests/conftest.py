"""Test configuration.

The CPU suite runs JAX on a virtual 8-device CPU mesh (the fake-backend
trick, SURVEY.md §4), so the multi-device sharding tests need no cards.
Tests marked `gpu` need the card: `pytest -m gpu` runs them on a machine
with one, and for that selection this file leaves JAX's platform alone.
Whether a card is present is decided inside the `gpu` fixture, never at
import, so every xdist worker collects the same tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture(scope="session")
def cpu_mesh_devices():
    assert len(jax.devices()) == 8
    return jax.devices()


@pytest.fixture
def gpu():
    """The default device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default backend: {dev.platform}); "
                    "run `pytest -m gpu` on the card")
    return dev


@pytest.fixture
def gpu_route(monkeypatch):
    """Route every transform as on a GPU, whatever the device: the CPU
    tests then drive the engines 'auto' picks on the card."""
    from concrete_ntt_tpu.ops import ntt_dispatch

    monkeypatch.delenv("CONCRETE_NTT_TPU_ENGINE", raising=False)
    monkeypatch.setattr(ntt_dispatch, "_platform", lambda: "gpu")
