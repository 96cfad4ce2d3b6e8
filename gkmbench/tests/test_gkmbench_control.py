"""The control: the plain reference in the program's place, one precision
step down, must come out not correct. On the card at the cells' own sizes
(``cuda``-marked); on the CPU at a tiny size it must at least read above
the program."""

import pytest
import torch

from gkmbench import control, harness
from gkmbench.tests.tiny import tiny_cell

CELLS = ["kat2b.train", "p219.train", "kat2b.approx", "kat2b.grid"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cells' own sizes")
    return "cuda"


def _judged(cell, seed, device):
    data = harness.load_module("loaders", cell.config["loader"]).load(cell.config, seed, harness.HERE)
    last, job = control.control_outputs(cell, data, seed, device)
    return harness.compare(cell, data, seed, last, harness.Window(0.0, [job], 0, []), device)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell, card):
    c = harness.load_cell(cell)
    numbers = _judged(c, 2**31 + 101, card)
    assert not harness.passed(harness.checks(numbers, c.limits)), numbers


@pytest.mark.parametrize("cell", ["kat2b.train", "kat2b.approx"])
def test_control_reads_above_the_program_at_a_tiny_size(cell, tmp_path):
    c = tiny_cell(cell)
    seed = 5
    data = harness.load_module("loaders", c.config["loader"]).load(c.config, seed, harness.HERE)
    fsk, job = harness.run_job(harness.import_program(), c, data, seed, "cpu", harness.no_span)
    last = harness.last_job_outputs(fsk, str(tmp_path))
    program = harness.compare(c, data, seed, last, harness.Window(0.0, [job], 0, []), "cpu")
    ctrl = _judged(c, seed, "cpu")
    assert ctrl["svm_gap"] > 3 * program["svm_gap"] and ctrl["proba"] > 3 * program["proba"]
