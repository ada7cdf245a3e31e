"""The metrics that read the program's spans and counters
(lizard_tpu_torch/utils/profiling.py), on whole runs of the cells cut to a
CPU size (tiny.py), with profiling.recording() standing in for the
profiler: a number in each metric's own cells, and None without records
(a --trace 0 run), with a root count other than the window's requests and
with dropped spans."""

import contextlib
import types

import pytest
import torch

from h100_bench import harness, tracing
from h100_bench.tests import tiny
from lizard_tpu_torch.utils import profiling

DECODE = ("split_ms.decode", "answer_ms.decode", "host_pct.decode",
          "staged_per_byte.decode")
METRICS = {
    "l10-decode-bulk": DECODE,
    "l41-decode-bulk": DECODE,
    "l41-encode-bulk": ("huf_plan_ms.encode", "emit_ms.encode",
                        "host_pct.encode", "staged_per_byte.encode"),
    "l10-frame-get": ("host_p95_ms.get",),
}
SEED = 2**31 + 21


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


@contextlib.contextmanager
def _recorded():
    """tracing.profile's stand-in: the window's spans recorded in memory,
    an empty device timeline."""
    holder = {}
    with profiling.recording():
        yield holder
    holder["summary"] = {"window_s": 1.0, "ops": []}
    holder["events"] = 0


def _reader(name):
    return harness.reader(tiny.BENCH + "/metrics", name)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metrics_read_their_cells(name, monkeypatch):
    monkeypatch.setattr(tracing, "profile", _recorded)
    res = harness.run_cell(tiny.cell(name, METRICS[name]), SEED, 0.05, True,
                           "cpu")
    assert res["correct"], res["checks"]
    for metric in METRICS[name]:
        value = res["metrics"][metric]["value"]
        assert isinstance(value, float) and value > 0, (metric, value)
        if "_pct." in metric:
            assert value < 100
    roots = [r for r in profiling.records() if r.parent is None]
    assert len(roots) == res["attempted"]
    off_by_one = types.SimpleNamespace(
        requests=len(roots) + 1, window_s=1.0, in_bytes=1, out_bytes=1)
    for metric in METRICS[name]:
        assert _reader(metric)(off_by_one) is None


def test_no_records_read_none():
    """A --trace 0 run records nothing: each metric reads None."""
    res = harness.run_cell(tiny.cell("l10-frame-get", sum(
        METRICS.values(), ())), SEED, 0.05, False, "cpu")
    assert res["correct"] and profiling.records() == []
    assert res["metrics"] == {}


def test_dropped_spans_read_none(monkeypatch):
    monkeypatch.setattr(tracing, "profile", _recorded)
    monkeypatch.setattr(profiling, "CAP", 5)
    res = harness.run_cell(tiny.cell("l10-decode-bulk", DECODE), SEED, 0.05,
                           True, "cpu")
    assert res["correct"] and profiling.counters()["spans_dropped"] > 0
    assert res["metrics"] == {}
