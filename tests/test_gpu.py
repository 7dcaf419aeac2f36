"""Tests that need the card.  They skip here; on the card run
`WRP_TEST_GPU=1 python -m pytest -m gpu tests/`."""

import numpy as np
import pytest

from wrp_tpu import DEFAULT_CONFIG
from wrp_tpu.parity import route_parity
from wrp_tpu.pipeline import METHODS, SectorProcessor

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("method", METHODS)
def test_route_full_width_parity_on_card(gpu_device, method):
    proc = SectorProcessor(DEFAULT_CONFIG, method=method, device=gpu_device)
    out = route_parity(proc, DEFAULT_CONFIG, gpu_device)
    assert out["ok"], out


def test_flagship_batch128_step_fits_the_card(gpu_device):
    proc = SectorProcessor(DEFAULT_CONFIG, device=gpu_device)
    mem = proc.lower(128, np.int16).compile().memory_analysis()
    assert mem.temp_size_in_bytes < 40e9
