"""The correctness check, driven through a whole run on the CPU (the
harness's look for a card skipped): every cell is correct as the program
runs it, and comes out not correct with the control or any planted fault
in the program's place."""

import pytest
import torch

from h100_bench import faults, harness
from h100_bench.tests import tiny

CELLS = ["l10-decode-bulk", "l41-decode-bulk", "l10-frame-get",
         "l41-encode-bulk"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = harness.run_cell(tiny.cell(name), 2**31 + 11, 0.05, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["forbidden"] == []


@pytest.mark.parametrize("plant", sorted(faults.PLANTS))
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(name, plant):
    c = tiny.cell(name)
    fn = faults.PLANTS[plant](harness.entry(c["traffic"]),
                              c["traffic"]["input"])
    res = harness.run_cell(c, 2**31 + 12, 0.05, False, "cpu", fn=fn)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
