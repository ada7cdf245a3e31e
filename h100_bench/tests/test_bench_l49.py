"""The cell `l49-encode-bulk` (the write path at -49, whose encoder runs the
hash-chain tier: match_find's delta map, chain_walk and the lazy-2 parse):
its entries keep the benchmark's layout, its run cut to a CPU size is
correct with the program's plain versions (device="cpu") and not with the
control, and its three chain metrics read what they should and None where
there is nothing to read."""

import contextlib
import os
import types

import pytest
import torch

from h100_bench import corpus, faults, harness, native, tracing
from h100_bench.reference import frame as ref_frame
from h100_bench.tests import tiny
from lizard_tpu_torch import api
from lizard_tpu_torch.utils import profiling

ROOT = os.path.dirname(tiny.BENCH)
CELL = "l49-encode-bulk"
CHAIN = ("chain_ms.encode", "chain_roofline_pct", "chain_replaced_pct.encode")
TRACED = ["encode_roofline_pct", "copy_ms.encode", "idle_pct.encode",
          "huf_plan_ms.encode", "emit_ms.encode", "host_pct.encode",
          "staged_per_byte.encode", *CHAIN]
SEED = 2**31 + 49
CARD = "NVIDIA H100 80GB HBM3"
WALK = ("void (anonymous namespace)::chain_walk_kernel<false>(unsigned "
        "char const*, unsigned short const*, int, int)")


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
    return harness.reader(os.path.join(tiny.BENCH, "metrics"), name)


def test_cell_keeps_the_layout():
    """One chip, the encode cells' end-to-end metrics, their per-layer
    metrics and the three chain metrics; a configuration with the keys of
    lizv1huf-l46's, level 49, 512 MiB of the configs' corpus recipe and
    nothing reduced; the traffic of the other encode cells."""
    spec = tiny.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {c["name"]: c for c in spec["workloads"]}[CELL]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert w["traffic"] == "encode_bulk"
    cell = harness.resolve(CELL, False, ROOT)
    assert [m for m, _ in cell["metrics"]] == ["encode_gbps",
                                                "compressed_pct", "setup_s"]
    assert [m for m, _ in harness.resolve(CELL, True, ROOT)["metrics"]] \
        == TRACED
    cfg = cell["config"]
    l46 = tiny.load_json(os.path.join(tiny.BENCH, "configs",
                                      "lizv1huf-l46.json"))
    assert set(cfg) == set(l46)
    assert (cfg["level"], cfg["block_bytes"], cfg["corpus_part_bytes"]) == \
        (49, 1 << 17, 4 << 20)
    assert cfg["corpus_bytes"] == 512 << 20
    assert cfg["corpus_kinds"] == l46["corpus_kinds"]
    assert cfg["guarantees"] == l46["guarantees"]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cell["traffic"]["request_bytes"] == 32 << 20
    assert cell["traffic"]["args"]["block_size_id"] == 4
    for m in spec["per_layer"]:
        if m["name"] in CHAIN:
            assert m["workloads"] == [CELL] and m["moves"] == "encode_gbps"
            assert m["layer"] == "encode kernels"


def test_cell_is_correct_with_its_chain_counts(monkeypatch):
    """A run of the cell cut to a CPU size, recorded: every answer right,
    the sampled block decoded by the plain reference, each call's root
    counting the walk's positions and replacements, so that
    chain_replaced_pct.encode reads their ratio; the empty timeline gives
    no kernel time."""
    monkeypatch.setattr(tracing, "profile", _recorded)
    res = harness.run_cell(tiny.cell(CELL, TRACED), SEED, 0.05, True, "cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["reference_blocks_wrong"]["value"] == 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    roots = [r for r in profiling.records() if r.parent is None]
    assert len(roots) == res["attempted"]
    positions = sum(r.counts["chain_walk.positions"] for r in roots)
    replaced = sum(r.counts["chain_walk.replaced"] for r in roots)
    assert 0 < replaced < positions
    assert res["metrics"]["chain_replaced_pct.encode"]["value"] == \
        pytest.approx(100 * replaced / positions)
    for metric in ("emit_ms.encode", "huf_plan_ms.encode",
                   "staged_per_byte.encode"):
        assert res["metrics"][metric]["value"] > 0, metric
    assert not {"chain_ms.encode", "chain_roofline_pct"} & set(res["metrics"])


def test_cell_control_fails():
    c = tiny.cell(CELL)
    fn = faults.control(harness.entry(c["traffic"]), "raw")
    res = harness.run_cell(c, SEED + 1, 0.05, False, "cpu", fn=fn)
    assert not res["correct"] and res["failed"] >= 1


def test_reference_decodes_a_l49_frame():
    """A -49 frame of 256 KiB of the configuration's corpus (4 KiB parts),
    written by the program as the cell calls it, decodes to its input
    through the plain reference and the frozen native frame decoder."""
    cfg = tiny.load_json(os.path.join(tiny.BENCH, "configs",
                                      "lizv1huf-l49.json"))
    data = corpus.build(SEED, 1 << 18, 1 << 12, cfg["corpus_kinds"])
    f = api.compress_frame(data, level=49, block_size_id=4,
                           content_checksum=True, backend="gpu",
                           device="cpu")
    assert len(f) < len(data)
    assert ref_frame.decode(f, native.xxh32) == data
    assert native.decompress_frame(f, len(data) + 1) == data


def _trace(*ops):
    return {"window_s": 1.0,
            "ops": [{"kind": kind, "name": name, "start_s": 0.0,
                     "dur_s": ms / 1e3, "launch": "cudaLaunchKernel"}
                    for kind, name, ms in ops]}


def test_chain_kernel_time_and_roofline():
    """chain_walk_kernel matched by its trace name, either instance, and
    no other kernel or copy; the roofline is the window's input bytes at
    the HBM rate over that time, None without a trace, a known card or
    the kernel."""
    trace = _trace(
        ("kernel", WALK, 2.0),
        ("kernel", WALK.replace("<false>", "<true>"), 1.0),
        ("kernel", "void (anonymous namespace)::match_find_kernel<1>(int)",
         4.0),
        ("kernel", "void (anonymous namespace)::parse_tokens_kernel<false>"
         "(int)", 8.0),
        ("memcpy", "Memcpy HtoD (Pageable -> Device)", 16.0))
    run = types.SimpleNamespace(trace=trace, requests=2, in_bytes=10**9,
                                device_kind=CARD)
    assert _reader("chain_ms.encode")(run) == pytest.approx(1.5)
    assert _reader("chain_roofline_pct")(run) == pytest.approx(
        100 * 1e9 / 3.35e12 / 0.003)
    run.device_kind = "unknown card"
    assert _reader("chain_roofline_pct")(run) is None
    run.device_kind = CARD
    run.trace = _trace(("kernel", "match_find_kernel<1>(int)", 4.0))
    assert _reader("chain_ms.encode")(run) is None
    assert _reader("chain_roofline_pct")(run) is None
    run.trace = None
    assert _reader("chain_ms.encode")(run) is None
    assert _reader("chain_roofline_pct")(run) is None


def test_replaced_share_guards():
    """The roots' replaced over positions; None without records, with a
    root count other than the requests, with dropped spans, and where no
    root counted a position (a program without the counters)."""
    read = _reader("chain_replaced_pct.encode")
    run = types.SimpleNamespace(requests=2)
    assert read(run) is None                        # nothing recorded
    with profiling.recording():
        for positions, replaced in ((300, 60), (500, 100)):
            with profiling.span("compress_frame", "host"):
                profiling.count("chain_walk.positions", positions)
                profiling.count("chain_walk.replaced", replaced)
    assert read(run) == pytest.approx(20.0)
    assert read(types.SimpleNamespace(requests=3)) is None
    profiling.count("spans_dropped")
    assert read(run) is None
    profiling.reset()
    with profiling.recording():
        for _ in range(2):
            with profiling.span("compress_frame", "host"):
                profiling.count("h2d_bytes", 10)
    assert read(run) is None
