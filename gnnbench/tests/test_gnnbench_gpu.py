"""On the card (marker ``gpu``; skips here): a run of each tiny cell on
the port's CUDA kernels comes out correct and reads device time."""
import pytest
import torch

from gnnbench import run
from gnnbench.tests.tiny import tiny_cell


@pytest.mark.gpu
@pytest.mark.parametrize("fam,loop", [(f, l) for f in ("gcn", "gat")
                                      for l in ("serve", "train")])
def test_tiny_cell_on_the_card(fam, loop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, lines = run.run_cell(tiny_cell(fam, loop), 2 ** 31 + 5, 0.5,
                                 True, torch.device("cuda", 0), 0.0)
    assert result["correct"], lines
    assert result["device"]["busy_s"] > 0
