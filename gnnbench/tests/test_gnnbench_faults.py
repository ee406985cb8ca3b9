"""At a size a test can hold, on the CPU with the port's plain versions:
a sound run comes out correct, and so does not each fault planted under
the timed path that the cell can have, nor the float8 control put in the
program's place.  The harness's look for a card is skipped
(``run_cell``); everything after it runs."""
import pytest
import torch

from gnnbench import calibrate, check, faults, run, spec
from gnnbench.tests.tiny import TINY_LIMITS, tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
CASES = [(f, l) for f in ("gcn", "gat") for l in ("serve", "train")]


def _run(fam, loop, program_cls=run.Program):
    result, lines = run.run_cell(tiny_cell(fam, loop), SEED, 0.2, False,
                                 CPU, 0.0, program_cls)
    return result, lines


@pytest.mark.parametrize("fam,loop", CASES)
def test_sound_run_is_correct(fam, loop):
    result, lines = _run(fam, loop)
    assert result["correct"] and result["failed"] == 0, lines
    assert result["attempted"] > 0


FAULT_CASES = ([(f, "serve", x) for f in ("gcn", "gat")
                for x in faults.SERVE_FAULTS]
               + [(f, "train", x) for f in ("gcn", "gat")
                  for x in faults.TRAIN_FAULTS])


@pytest.mark.parametrize("fam,loop,fault", FAULT_CASES)
def test_fault_is_not_correct(fam, loop, fault):
    result, lines = _run(fam, loop, faults.FAULTS[fault])
    assert not result["correct"] and result["failed"] >= 1, lines


@pytest.mark.parametrize("fam,loop", CASES)
def test_control_is_not_correct(fam, loop):
    cell = tiny_cell(fam, loop)
    r = run.Run(cell, SEED, CPU)
    r.set_up_program()
    rg = calibrate.verify.reference_graph(cell.config, CPU)
    numbers = calibrate.control_numbers(r, SEED, rg)
    correct, failed, _ = check.judge(numbers, cell.limits)
    assert not correct and failed >= 1, numbers


@pytest.mark.parametrize("fam,loop", CASES)
def test_tiny_limits_compare_the_cells_numbers(fam, loop):
    assert set(TINY_LIMITS[(fam, loop)]) == set(
        spec.cell(f"{fam}2_e11m_{loop}").limits)
