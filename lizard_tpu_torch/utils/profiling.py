"""Spans, counters and torch.profiler traces: the port's one tracing
facility (the port of lizard_tpu/utils/profiling.py).

Spans mark the layer boundaries of the decode, encode and frame paths:

    with span("split", "host"):       # pure host work
        ...
    with span("lz_decode", "device"): # issues copies or kernels, or waits
        ...

A span records only while a torch profiler runs, or inside `recording()`;
otherwise `span` returns one shared no-op object (no allocation, no clock
read, no record_function). When it records it enters a `record_function`
named "lizard.<name>" if a profiler runs, so the span sits on the device
trace's clock around the runtime calls of its stage, and it keeps a
`Record` in memory (at most CAP; more are counted in "spans_dropped").
The outermost span of a thread is a root; every span under it carries the
root's sequence number as its request id, and a root also carries the
counters' increments over it. `traced(name, kind)` is the decorator form.
No span synchronises, reads a device value or allocates on a device.

Counters (`count`) are always on: host integers, one dict add each under
a lock (the sharded paths count from threads). The
port counts the bytes each staging call hands to a device ("h2d_bytes")
and each readback takes from it ("d2h_bytes"), from host-known sizes
whatever the device, each kernel wrapper's calls ("<kernel>.launches")
and kernels launched ("<kernel>.kernel_launches"), and the inner blocks
and Huff0 blobs of each batch that the native host split and plan handled
("split.native_blocks", "plan.native_blobs"; ops/host_plan.py).

`trace(logdir)` writes a Chrome trace of its block; `report()` prints the
spans' totals and the counters, for operators.
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _autograd_profiler

KINDS = ("host", "device")
CAP = 1 << 18                       # records kept between two resets
PREFIX = "lizard."                  # of every span's record_function


@dataclass(slots=True)
class Record:
    """One span: `start_ns` and `end_ns` on time.perf_counter_ns(),
    `parent` the enclosing span's `id` (None for a root), `request` the
    root's sequence number, `counts` (roots only) the counters' increments
    over the root."""
    id: int
    name: str
    kind: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    request: int
    counts: dict | None = None


_counts: dict[str, int] = {}
_lock = threading.Lock()            # counters are added to from threads
_records: list[Record] = []
_ids = itertools.count(1)
_roots = itertools.count(1)
_open = threading.local()           # .stack: the thread's open records
_recording = 0                      # depth of recording() blocks


class _Off:
    """The shared span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "kind", "rec", "fn", "before")

    def __init__(self, name: str, kind: str):
        if kind not in KINDS:
            raise ValueError(f"span kind must be one of {KINDS}, not {kind!r}")
        self.name, self.kind = name, kind
        self.fn = self.before = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            top = stack[-1]
            rec = Record(next(_ids), self.name, self.kind, 0, None, top.id,
                         top.request)
        else:
            rec = Record(next(_ids), self.name, self.kind, 0, None, None,
                         next(_roots))
            with _lock:
                self.before = dict(_counts)
        self.rec = rec
        if _autograd_profiler._is_profiler_enabled:
            self.fn = torch.autograd.profiler.record_function(
                PREFIX + self.name)
            self.fn.__enter__()
        stack.append(rec)
        if len(_records) < CAP:
            _records.append(rec)
        else:
            count("spans_dropped")
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        if self.before is not None:
            with _lock:
                rec.counts = {k: v - self.before.get(k, 0)
                              for k, v in _counts.items()
                              if v != self.before.get(k, 0)}
        return False


def active() -> bool:
    """Whether spans record: a torch profiler runs, or inside recording()."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


def span(name: str, kind: str):
    """A context manager that records the block as span `name` of `kind`
    ("host": pure host work; "device": issues copies or kernels or waits
    for them) while spans record (active()); else the shared no-op."""
    if active():
        return _Span(name, kind)
    return _OFF


def traced(name: str, kind: str):
    """Decorator: every call of the function runs inside span(name, kind)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, kind):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record spans in memory inside the block, with no profiler running
    (no record_function is entered then)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count_bytes(name: str, *tensors) -> None:
    """Add the byte sizes of `tensors` to counter `name`."""
    count(name, sum(t.numel() * t.element_size() for t in tensors))


def counters() -> collections.Counter:
    """A copy of every counter (a missing one reads 0)."""
    with _lock:
        return collections.Counter(_counts)


def records() -> list[Record]:
    """The spans recorded since the last reset, in the order they opened."""
    return list(_records)


def reset() -> None:
    """Clear the counters, the records and the root numbering."""
    global _roots
    with _lock:
        _counts.clear()
    _records.clear()
    _roots = itertools.count(1)


def self_ns(recs: list[Record]) -> list[int]:
    """Each record's duration less the part of it that its children in
    `recs` cover (the union of their intervals). Every record is closed."""
    kids = collections.defaultdict(list)
    for r in recs:
        if r.parent is not None:
            kids[r.parent].append((r.start_ns, r.end_ns))
    out = []
    for r in recs:
        covered, end = 0, r.start_ns
        for a, b in sorted(kids.get(r.id, ())):
            a, b = max(a, end), min(b, r.end_ns)
            if b > a:
                covered += b - a
                end = b
        out.append(r.end_ns - r.start_ns - covered)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the CPU and, where present, the CUDA
    activity of the block, spans included, written to logdir/trace.json;
    yields the profile, whose key_averages() give the device time by
    kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def report(reset_after: bool = False) -> str:
    """One line per span name (spans, total and self ms, kind), then one
    per counter."""
    recs = [r for r in _records if r.end_ns is not None]
    totals = collections.defaultdict(lambda: [0, 0, 0, ""])
    for r, own in zip(recs, self_ns(recs)):
        t = totals[r.name]
        t[0] += 1
        t[1] += r.end_ns - r.start_ns
        t[2] += own
        t[3] = r.kind
    lines = [f"{name:>16}: n={n:<6d} total={total / 1e6:10.3f}ms "
             f"self={own / 1e6:10.3f}ms {kind}"
             for name, (n, total, own, kind) in sorted(totals.items())]
    lines += [f"{name:>24}: {v}" for name, v in sorted(counters().items())]
    if reset_after:
        reset()
    return "\n".join(lines)
