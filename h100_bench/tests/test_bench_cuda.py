"""On the card only (marker `cuda`): each cell's run prints a correct
result line in the contract's shape, and its control comes out not
correct. Run on the card with
`python3 -m pytest -q -m cuda h100_bench/tests/test_bench_cuda.py`."""

import json
import os
import subprocess
import sys

import pytest

from h100_bench.tests import tiny

ROOT = os.path.dirname(tiny.BENCH)
CELLS = [w["name"] for w in tiny.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(script, *args):
    r = subprocess.run([sys.executable, os.path.join(tiny.BENCH, script),
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name, trace):
    r = _run("run.py", "--workload", name, "--seed", str(2**31 + 21),
             "--seconds", "2", "--trace", str(trace))
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] >= 1
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(card, name):
    r = _run("control.py", "--workload", name, "--plant", "control",
             "--seeds", str(2**31 + 22), "--seconds", "0.1")
    assert not json.loads(r.stdout.strip().splitlines()[-1])["correct"]
