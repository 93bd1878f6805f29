"""Tests that need the card: `pytest -m gpu` on a machine with an NVIDIA
GPU. Each skips elsewhere (the `gpu` fixture decides, at run time).

They run chip_smoke.py's phases at full width under the routing 'auto'
picks there, and check that the two engines agree to the bit on the card."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_main_path_bit_exact_on_card(gpu):
    names = [name for name, _ in chip_smoke.main_phases(np.random.default_rng(1))]
    assert "native128-Plan32" in names


def test_engines_agree_on_card(gpu):
    rows = list(chip_smoke.engine_ab(np.random.default_rng(2), calls=2))
    assert len(rows) == 3


def test_routing_on_card_uses_the_gpu_row(gpu):
    from concrete_ntt_tpu.ops import ntt_dispatch

    assert ntt_dispatch._platform() == "gpu"
    assert ntt_dispatch.route(32, 1 << 14) == ntt_dispatch.ROUTES["gpu"][32]
