"""On the card (marked ``cuda``; skipped where there is none): a small run
of each cell is correct there, and its control fails."""

import pytest
import torch

from perfbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_small_run_on_the_card_is_correct(tmp_path, card, cell):
    line = tiny.run_small(tmp_path, cell, device=card, trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_a_small_run_on_the_card_reads_the_device_rate(tmp_path, card):
    # several steps: the profiler drops a step's records now and then, and
    # such a step is left out of the rate
    line = tiny.run_small(tmp_path, tiny.CELLS[0], device=card, seconds=10)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["env_frames_per_device_s"]["value"] > 0
