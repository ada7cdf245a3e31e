"""utils/profiling.py, the port's spans and counters, on the paths the
benchmark's cells call: a bulk decode (ops/lane_decode.py::
decompress_lanes), a frame GET (frame.decompress_frame) and a frame encode
(frame.compress_frame_lanes), all at level 41 (the Huff0 stage on both
paths) with device="cpu", where every kernel wrapper runs its plain
version."""

import json
import sys
import threading
import types

import pytest
import torch

from lizard_tpu_torch import frame, runtime
from lizard_tpu_torch.format.constants import LIZARD_BLOCK_SIZE
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops.split import split_streams
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import gen, text_like

LEVEL = 41
# each path's spans in the order they open, each with its parent's name
# (every span of these paths is a child of the root)
DECODE = ["decompress_lanes", "split", "plan", "stage", "stage",
          "huf_decode", "lz_decode", "readback", "readback", "answer",
          "answer"]
GET = ["decompress_frame", "frame_parse", "split", "plan", "stage", "stage",
       "huf_decode", "lz_decode", "readback", "readback", "answer", "answer",
       "answer", "xxh32"]
ENCODE = ["compress_frame", "pack", "match_find", "parse_tokens", "tokens",
          "emit", "huf_plan", "huf_plan", "huf_pack", "huf_readback",
          "huf_readback", "huf_finish", "assemble", "xxh32"]
HOST = {"split", "plan", "answer", "frame_parse", "xxh32", "emit",
        "huf_plan", "huf_finish", "assemble"}


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


@pytest.fixture(scope="module")
def data() -> bytes:
    return text_like(20_000, seed=1)


@pytest.fixture(scope="module")
def streams(data) -> list[bytes]:
    return [runtime.compress(data, LEVEL),
            runtime.compress(gen(20_000, seed=2), LEVEL)]


@pytest.fixture(scope="module")
def lz_frame(data) -> bytes:
    return frame.compress_frame_lanes(data, LEVEL, block_size_id=1,
                                      device="cpu")


def _paths(data, streams, lz_frame):
    """name -> (call, its expected spans)."""
    return {
        "decode": (lambda: tld.decompress_lanes(streams, device="cpu"),
                   DECODE),
        "get": (lambda: frame.decompress_frame(lz_frame, device="cpu"), GET),
        "encode": (lambda: frame.compress_frame_lanes(
            data, LEVEL, block_size_id=1, device="cpu"), ENCODE),
    }


def test_no_profiler_no_record(monkeypatch, data, streams, lz_frame):
    """Off (no profiler, no recording()): a decode, a frame GET and a frame
    encode leave no record, enter no record_function, read no span clock,
    and every span is the one shared no-op."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def no_clock():
        raise AssertionError("a span read the clock")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock))
    paths = _paths(data, streams, lz_frame)
    for call, _ in paths.values():
        call()
    assert profiling.records() == [] and entered == []
    assert profiling.span("a", "host") is profiling.span("b", "device")
    assert profiling.counters()["lz_decode.launches"] == 0    # no kernel


@pytest.mark.parametrize("path", ["decode", "get", "encode"])
def test_spans_nest_per_path(path, data, streams, lz_frame):
    """Under recording(): the path's spans in order, each a child of the
    root, one request id per root call, and the self times, the roots'
    included, adding up to each root's duration."""
    call, want = _paths(data, streams, lz_frame)[path]
    with profiling.recording():
        call()
        call()
    recs = profiling.records()
    assert [r.name for r in recs] == want + want
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [want[0]] * 2
    assert [r.request for r in roots] == [1, 2]
    for root in roots:
        mine = [r for r in recs if r.request == root.request]
        assert len(mine) == len(want)
        assert all(r.parent == root.id for r in mine if r is not root)
        assert all((r.kind == "host") == (r.name in HOST)
                   for r in mine if r is not root)
        own = profiling.self_ns(mine)
        assert all(s >= 0 for s in own)
        assert sum(own) == root.end_ns - root.start_ns
    assert roots[0].counts["h2d_bytes"] > 0
    assert roots[0].counts["d2h_bytes"] > 0
    assert roots[0].counts == roots[1].counts
    assert profiling.counters()["spans_dropped"] == 0


def test_staged_bytes_of_a_known_batch():
    """h2d_bytes: the staged streams, block table and chain table; d2h_bytes:
    the chain table, block lengths and chain statuses read back, and the
    span of the output from the first block's start to the last one's end
    (so the unused capacity of the first stream's block too); a root's
    counts are its call's."""
    parts = [gen(5_000, seed=4), gen(9_000, seed=5, proba=0.6)]
    streams = [runtime.compress(p, 10) for p in parts]
    batch = split_streams(streams)
    args = tld.stage_batch(batch, "cpu")
    staged = sum(t.numel() * t.element_size() for t in args.values()
                 if isinstance(t, torch.Tensor))
    assert staged == (sum(len(getattr(batch, k).numpy().tobytes())
                          for k in ("flags", "literals", "off16", "off24"))
                      + batch.n_blocks * 8 * 8 + len(streams) * 3 * 8)
    assert profiling.counters()["h2d_bytes"] == staged
    out = tld.read_blocks(batch, args, *tld.lz_decode(**args))
    assert b"".join(out) == b"".join(parts)
    read = (len(streams) * 3 * 8 + batch.n_blocks * 4 + len(streams) * 4
            + LIZARD_BLOCK_SIZE + len(parts[1]))
    assert profiling.counters()["d2h_bytes"] == read
    profiling.reset()
    with profiling.recording():
        assert tld.decompress_lanes(streams, device="cpu") == parts
    counts = profiling.records()[0].counts
    assert counts["h2d_bytes"] == staged and counts["d2h_bytes"] == read
    assert counts == {k: v for k, v in profiling.counters().items() if v}


def test_chrome_trace_holds_every_span(tmp_path, lz_frame):
    """Under torch.profiler: one lizard.<name> user annotation per record,
    in the same order and with the same nesting."""
    with profiling.trace(str(tmp_path)):
        frame.decompress_frame(lz_frame, device="cpu")
    recs = profiling.records()
    assert [r.name for r in recs] == GET
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith(profiling.PREFIX)),
                 key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ann] == [profiling.PREFIX + n for n in GET]
    stack, parents = [], []
    for e in ann:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        parents.append(stack[-1]["name"] if stack else None)
        stack.append(e)
    by_id = {r.id: profiling.PREFIX + r.name for r in recs}
    assert parents == [by_id.get(r.parent) for r in recs]


def test_record_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with profiling.recording():
        with profiling.span("root", "host"):
            for _ in range(4):
                with profiling.span("leaf", "device"):
                    pass
    assert [r.name for r in profiling.records()] == ["root", "leaf", "leaf"]
    assert profiling.counters()["spans_dropped"] == 2
    with pytest.raises(ValueError, match="kind"):
        with profiling.recording(), profiling.span("x", "gpu"):
            pass


def test_self_time_takes_the_union_of_children():
    """Children that overlap (spans of other threads under one parent)
    are counted once."""
    R = profiling.Record
    recs = [R(1, "root", "host", 0, 100, None, 1),
            R(2, "a", "device", 10, 50, 1, 1),
            R(3, "b", "device", 40, 70, 1, 1),
            R(4, "c", "host", 90, 95, 1, 1)]
    assert profiling.self_ns(recs) == [100 - 60 - 5, 40, 30, 5]


def test_counters_lose_no_update_across_threads():
    """Eight threads adding to one counter with a short switch interval:
    the total is exact."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            profiling.count("x") for _ in range(5_000)]) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["x"] == 40_000
