"""On a CUDA card: each cell at its own size for a short window comes out
correct, and with the control in place, not correct. Skips without a card."""

import time

import pytest
import torch

import control
import harness

CELLS = [w["name"] for w in harness.load_json(
    f"{harness.ROOT}/BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card_is_correct_and_its_control_is_not(card, name):
    result = harness.run(name, 2**31 + 99, 1.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    bad = harness.run(name, 2**31 + 99, 0.5, False, card, time.perf_counter(),
                      make_codec=control.ControlCodec)
    assert not bad["correct"]
