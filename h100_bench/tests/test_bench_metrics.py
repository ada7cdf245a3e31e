"""The yardstick's arithmetic on a synthetic trace: the summary built
from raw profiler events, busy and idle time, copy and kernel time, the
roofline's bytes and each metric file's reading."""

import types

import pytest

from h100_bench import harness, roofline, tracing
from h100_bench.tests import tiny


def ev(name, cat, start_ms, dur_ms, corr=None):
    """A Chrome trace event as torch.profiler exports it (microseconds)."""
    e = {"ph": "X", "cat": cat, "name": name, "ts": T + start_ms * 1e3,
         "dur": dur_ms * 1e3, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


T = 1.7e15


def events():
    """A 10 ms window: a 1 ms copy in, 2 ms and 1 ms kernels that overlap
    by 0.5 ms, a 0.5 ms copy out, a fill; one kernel outside the window
    and one that straddles its end."""
    return [
        ev(tracing.WINDOW, "user_annotation", 0, 10),
        ev(tracing.WINDOW, "gpu_user_annotation", 0.2, 10),
        ev("cudaMemcpyAsync", "cuda_runtime", 0, 0.01, 1),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1, 1, 1),
        ev("cudaLaunchKernel", "cuda_runtime", 0, 0.01, 2),
        ev("lz_decode_pass1", "kernel", 3, 2, 2),
        ev("cudaLaunchKernel", "cuda_runtime", 0, 0.01, 3),
        ev("scan", "kernel", 4.5, 1, 3),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 6, 0.5, 4),
        ev("Memset (Device)", "gpu_memset", 7, 0.25, 5),
        ev("early", "kernel", -2, 1, 6),
        ev("late", "kernel", 9.5, 1, 7),
        ev("aten::copy_", "cpu_op", 1, 1, 8),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": T, "id": 1},
    ]


def test_summary_clips_to_the_window_and_names_launches():
    s = tracing.summarize(events())
    assert s["window_s"] == pytest.approx(0.010)
    names = [op["name"] for op in s["ops"]]
    assert "early" not in names and names[-1] == "late"
    assert s["ops"][-1]["dur_s"] == pytest.approx(0.0005)
    assert s["ops"][0]["launch"] == "cudaMemcpyAsync"
    assert s["ops"][1]["launch"] == "cudaLaunchKernel"
    assert s["ops"][3]["launch"] == "unknown"
    assert [op["kind"] for op in s["ops"]] == [
        "memcpy", "kernel", "kernel", "memcpy", "memset", "kernel"]


def test_check_spans_are_cut_out():
    """A 2 ms check between 5.5 and 7.5 ms: the window is 8 ms, and the
    copy out and the fill move 2 ms earlier."""
    evs = [e for e in events() if e["name"] not in (
        "Memcpy DtoH (Device -> Pageable)", "Memset (Device)")]
    evs += [ev(tracing.CHECK, "user_annotation", 5.5, 2),
            ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 8, 0.5, 4)]
    s = tracing.summarize(evs)
    assert s["window_s"] == pytest.approx(0.008)
    out = [op for op in s["ops"] if op["name"].startswith("Memcpy DtoH")][0]
    assert out["start_s"] == pytest.approx(0.006)
    assert out["dur_s"] == pytest.approx(0.0005)
    assert s["ops"][-1]["name"] == "late"
    assert s["ops"][-1]["start_s"] == pytest.approx(0.0075)
    assert s["ops"][-1]["dur_s"] == pytest.approx(0.0005)


def test_busy_idle_copy_kernel_and_count():
    s = tracing.summarize(events())
    # busy: 1 + (3..5.5) 2.5 + 0.5 + 0.25 + 0.5 = 4.75 ms of 10
    assert tracing.busy_s(s) == pytest.approx(0.00475)
    assert tracing.idle_pct(s) == pytest.approx(52.5)
    assert tracing.kind_s(s, "memcpy") == pytest.approx(0.0015)
    assert tracing.kind_s(s, "kernel") == pytest.approx(0.0035)
    assert tracing.count(s) == 6


def test_breakdown_lists_ops_and_gaps():
    b = tracing.breakdown(tracing.summarize(events()))
    assert b["device_ops"][0] == ["lz_decode_pass1", pytest.approx(0.002)]
    # idle: 0-1 ms, 2-3, 5.5-6, 6.5-7, 7.25-9.5 (ended by "late")
    assert b["idle_gaps"][0] == ["unknown -> late", pytest.approx(0.00225)]
    assert b["idle_gaps"][1] == ["cudaMemcpyAsync -> Memcpy HtoD "
                                 "(Pageable -> Device)", pytest.approx(0.001)]
    assert len(b["idle_gaps"]) == 5
    assert all(len(b[k]) <= 10 for k in b)


def _run(**kw):
    base = dict(setup_s=12.5, window_s=2.0, latencies_s=[0.001] * 99 + [0.1],
                requests=4, in_bytes=10**9, out_bytes=3 * 10**9,
                trace=tracing.summarize(events()),
                device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_roofline_counts_work_bytes_not_layout():
    run = _run()
    floor_s = 4e9 / 3.35e12
    assert roofline.pct(run) == pytest.approx(100 * floor_s / 0.0035)
    assert roofline.pct(_run(device_kind="unknown card")) is None
    assert roofline.pct(_run(trace=None)) is None
    nothing = {"window_s": 1.0, "ops": []}
    assert roofline.pct(_run(trace=nothing)) is None
    assert tracing.idle_pct(nothing) is None


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5),
    ("decode_gbps", 1.5),
    ("encode_gbps", 0.5),
    ("compressed_pct", 300.0),
    ("copy_ms.decode", 0.375),
    ("copy_ms.encode", 0.375),
    ("idle_pct.decode", 52.5),
    ("idle_pct.encode", 52.5),
    ("idle_pct.get", 52.5),
    ("kernel_ms.get", 0.875),
    ("device_ops.get", 1.5),
])
def test_metric_files(name, want):
    read = harness.reader(tiny.BENCH + "/metrics", name)
    assert read(_run()) == pytest.approx(want)


def test_tail_and_missing_trace():
    read = harness.reader(tiny.BENCH + "/metrics", "get_p95_ms")
    assert read(_run(latencies_s=[i / 1000 for i in range(1, 101)])) == \
        pytest.approx(95.05)
    for name in ("copy_ms.decode", "idle_pct.get", "kernel_ms.get",
                 "device_ops.get", "decode_roofline_pct"):
        assert harness.reader(tiny.BENCH + "/metrics", name)(
            _run(trace=None)) is None
