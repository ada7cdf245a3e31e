"""The traced run's device timeline, reduced to what the per-layer metrics
read: every operation that ran on the card inside the measured window
(kernels, copies, fills), each with the CUDA runtime call that issued it.

`profile()` wraps the window in torch.profiler with CPU and CUDA activities
and a user annotation that marks the window on the profiler's own clock,
and exports the profiler's trace (Chrome trace format, whose event
categories and correlation ids are stable across torch versions) to a fixed
file in the checkout's cache; `summarize()` reduces its events to a plain
dict that the metric readers and the tests share:

    {"window_s": float,
     "ops": [{"kind": "kernel" | "memcpy" | "memset", "name": str,
              "start_s": float, "dur_s": float, "launch": str}, ...]}

Times are seconds from the window's start, clipped to the window, with
the spans of the benchmark's own checks (annotated CHECK) cut out of the
timeline, as the host-clock window cuts them out of its time. The
readers below are the yardstick's arithmetic; each per-layer metric file
under metrics/ picks one.
"""

import bisect
import contextlib
import itertools
import json
import os

WINDOW = "h100_bench.window"
CHECK = "h100_bench.check"      # the benchmark's own checks, cut out
TRACE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".cache", "h100_bench", "trace.json")
_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@contextlib.contextmanager
def profile():
    """Profile the body; yields a holder whose "summary" is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    holder = {}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(TRACE), exist_ok=True)
    prof.export_chrome_trace(TRACE)
    with open(TRACE) as f:
        events = json.load(f)["traceEvents"]
    os.remove(TRACE)
    holder["summary"] = summarize(events)
    holder["events"] = len(events)


def summarize(events) -> dict:
    """The summary of a Chrome trace's events (times in microseconds)."""
    lo = hi = None
    runtime, device, checks = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation" and e["name"] == WINDOW:
            lo, hi = e["ts"], e["ts"] + e["dur"]
        elif cat == "user_annotation" and e["name"] == CHECK:
            checks.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime[corr] = e["name"]
        elif cat in _KINDS:
            device.append((_KINDS[cat], e["name"], e["ts"], e["dur"], corr))
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    squeeze = _squeezer(lo, hi, checks)
    ops = []
    for kind, name, start, dur, corr in sorted(device, key=lambda d: d[2]):
        a, b = squeeze(start), squeeze(start + dur)
        if b > a:
            ops.append({"kind": kind, "name": name, "start_s": a,
                        "dur_s": b - a,
                        "launch": runtime.get(corr, "unknown")})
    return {"window_s": squeeze(hi), "ops": ops}


def _squeezer(lo, hi, cuts):
    """t (us) -> seconds from lo, clipped to [lo, hi], with the time of the
    disjoint spans `cuts` that lies before t taken out."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in cuts
                   if e > lo and s < hi)
    starts = [s for s, _ in spans]
    done = list(itertools.accumulate((e - s for s, e in spans), initial=0))

    def squeeze(t):
        t = min(max(t, lo), hi)
        k = bisect.bisect_right(starts, t)
        inside = min(spans[k - 1][1], t) - spans[k - 1][0] if k else 0
        return (t - lo - done[k - 1] - inside if k else t - lo) / 1e6
    return squeeze


def busy_s(summary: dict) -> float:
    """Seconds of the window in which some operation ran on the card."""
    busy, end = 0.0, 0.0
    for op in summary["ops"]:       # sorted by start
        a, b = op["start_s"], op["start_s"] + op["dur_s"]
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_pct(summary: dict) -> float | None:
    """None when the trace saw nothing run on the card at all."""
    if not summary["ops"]:
        return None
    return 100.0 * (1.0 - busy_s(summary) / summary["window_s"])


def kind_s(summary: dict, kind: str) -> float:
    return sum(op["dur_s"] for op in summary["ops"] if op["kind"] == kind)


def count(summary: dict) -> int:
    return len(summary["ops"])


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps, each named by the runtime call and the operation
    that ended it (or the window's end)."""
    by_name = {}
    for op in summary["ops"]:
        by_name[op["name"]] = by_name.get(op["name"], 0.0) + op["dur_s"]
    gaps, end = [], 0.0
    for op in summary["ops"]:
        if op["start_s"] > end:
            gaps.append((f"{op['launch']} -> {op['name'][:80]}",
                         op["start_s"] - end))
        end = max(end, op["start_s"] + op["dur_s"])
    if summary["window_s"] > end:
        gaps.append(("window end", summary["window_s"] - end))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
