"""Tracing and host stage timers: the port of lizard_tpu/utils/profiling.py
(the reference times with programs/bench.c and util.h clocks; the port has
torch.profiler device traces plus light host stage timers).

Usage:
    from lizard_tpu_torch.utils.profiling import trace, stage, report

    with trace("/path/to/dir") as prof:   # CPU + CUDA timeline
        with stage("decode"):             # host wall-clock stage counter
            ...
    print(report())

`trace` writes a Chrome trace (trace.json) into the directory and yields
the torch.profiler.profile object, so its key_averages() give the device
time by kernel.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch

_STAGES: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the CPU and, where present, the CUDA
    activity of the block, written to logdir/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def stage(name: str):
    """Accumulating host wall-clock timer for a pipeline stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGES[name].append(time.perf_counter() - t0)


def annotate(name: str):
    """torch.profiler.record_function context: labels a host span inside
    a trace."""
    return torch.profiler.record_function(name)


def stages() -> dict[str, list[float]]:
    """Every stage's seconds so far, one entry a call."""
    return {k: list(v) for k, v in _STAGES.items()}


def report(reset: bool = False) -> str:
    """One line per stage: calls, total, mean."""
    lines = []
    for name in sorted(_STAGES):
        ts = _STAGES[name]
        lines.append(f"{name:>20}: n={len(ts):<5d} total={sum(ts):8.3f}s "
                     f"mean={sum(ts) / len(ts) * 1e3:9.3f}ms")
    if reset:
        _STAGES.clear()
    return "\n".join(lines)


def reset() -> None:
    _STAGES.clear()
