"""The cells `l46-frame-b4` (-B4 frames at -46, whose blocks the program
decodes as chains of inner blocks, so that lz_decode's pass 2 runs) and
`l10-encode-bulk` (the write path at -10, with no Huff0 stage): their
entries keep the benchmark's layout, their runs cut to a CPU size are
correct with the program's plain versions (device="cpu") and not with the
control, and the two pass-2 metrics read what they should and None where
there is nothing to read."""

import contextlib
import os
import types

import pytest
import torch

from h100_bench import faults, harness, tracing
from h100_bench.tests import tiny
from lizard_tpu_torch.utils import profiling

ROOT = os.path.dirname(tiny.BENCH)
CHAIN, ENCODE = "l46-frame-b4", "l10-encode-bulk"
PASS2 = ("pass2_ms.decode", "deferred_per_byte.decode")
TRACED = {
    CHAIN: ["decode_roofline_pct", "copy_ms.decode", "idle_pct.decode",
            "split_ms.decode", "answer_ms.decode", "host_pct.decode",
            "staged_per_byte.decode", *PASS2],
    ENCODE: ["encode_roofline_pct", "copy_ms.encode", "idle_pct.encode",
             "emit_ms.encode", "host_pct.encode", "staged_per_byte.encode"],
}
UNTRACED = {CHAIN: ["decode_gbps", "setup_s"],
            ENCODE: ["encode_gbps", "compressed_pct", "setup_s"]}
SEED = 2**31 + 31
INNER = 1 << 17


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


def _chain_cell(metrics=("setup_s",)) -> dict:
    """l46-frame-b4 with a 768 KiB corpus in 256 KiB parts and 384 KiB
    requests: the frame writer then takes 1 MiB blocks (the smallest that
    holds the request), so each frame is one block, a chain of three
    inner blocks."""
    c = tiny.cell(CHAIN, metrics)
    c["config"].update(corpus_bytes=3 * (1 << 18), corpus_part_bytes=1 << 18,
                       block_bytes=INNER)
    c["traffic"].update(request_bytes=3 * INNER)
    return c


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


@pytest.mark.parametrize("name", [CHAIN, ENCODE])
def test_new_cells_keep_the_layout(name):
    """One chip, a why of at most 200 characters, a configuration and a
    traffic mix with the keys of the files beside them, the end-to-end
    metrics of their kind with setup_s, and the per-layer metrics named
    for them (no Huff0 metric at -10)."""
    spec = tiny.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {c["name"]: c for c in spec["workloads"]}[name]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cell = harness.resolve(name, False, ROOT)
    assert [m for m, _ in cell["metrics"]] == UNTRACED[name]
    assert [m for m, _ in harness.resolve(name, True, ROOT)["metrics"]] \
        == TRACED[name]
    known = tiny.load_json(os.path.join(tiny.BENCH, "configs",
                                        "lizv1huf-l41.json"))
    assert set(cell["config"]) == set(known)
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    assert cell["config"]["reduced"] == entry["reduced"] == ["corpus_bytes"]
    assert cell["config"]["block_bytes"] == INNER
    if name == CHAIN:
        assert cell["config"]["level"] == 46
        known = tiny.load_json(os.path.join(tiny.BENCH, "traffic",
                                            "frame_get.json"))
        assert set(cell["traffic"]) == set(known)
        assert cell["traffic"]["block_size_id"] == 4
        assert cell["traffic"]["request_bytes"] == 32 << 20
    for m in spec["per_layer"]:
        if m["name"] in PASS2:
            assert m["workloads"] == [CHAIN]
            assert m["moves"] == "decode_gbps"


def test_chain_cell_is_correct_and_counts_its_chains(monkeypatch):
    """A run of the cut cell, recorded: every answer right, each call one
    chain of three inner blocks (two for pass 2). The plain versions keep
    no pass-2 record and the timeline is empty, so both pass-2 metrics
    read None."""
    monkeypatch.setattr(tracing, "profile", _recorded)
    res = harness.run_cell(_chain_cell(TRACED[CHAIN]), SEED, 0.05, True,
                           "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    roots = [r for r in profiling.records() if r.parent is None]
    assert len(roots) == res["attempted"]
    for r in roots:
        assert r.counts["lz_decode.chains"] == 1
        assert r.counts["lz_decode.pass2_blocks"] == 2
    assert res["metrics"]["staged_per_byte.decode"]["value"] > 0
    assert not set(PASS2) & set(res["metrics"])


def test_chain_cell_control_fails():
    c = _chain_cell()
    fn = faults.control(harness.entry(c["traffic"]), "frame")
    res = harness.run_cell(c, SEED + 1, 0.05, False, "cpu", fn=fn)
    assert not res["correct"] and res["failed"] >= 1


def test_pass2_metrics_read_none_without_trace_or_spans():
    run = types.SimpleNamespace(trace=None, requests=3, window_s=1.0,
                                in_bytes=1, out_bytes=1)
    for name in PASS2:
        assert _reader(name)(run) is None
    res = harness.run_cell(_chain_cell(PASS2), SEED, 0.05, False, "cpu")
    assert res["correct"] and res["metrics"] == {}


def test_pass2_ms_reads_link_jump_compact():
    """The kernels' trace names, namespace and argument list included;
    pass1, scan and torch's kernels are not pass 2."""
    ops = [("(anonymous namespace)::pass1(unsigned char const*, long)", 4.0),
           ("(anonymous namespace)::scan(long const*, long)", 0.5),
           ("(anonymous namespace)::link(long const*, unsigned int*, long)",
            1.0),
           ("(anonymous namespace)::jump(long const*, unsigned char*)", 2.0),
           ("(anonymous namespace)::compact(long const*, unsigned char*)",
            0.25),
           ("void at::native::reduce_kernel<512, 1>(at::native::Reduce)", 1.0)]
    trace = {"window_s": 1.0,
             "ops": [{"kind": "kernel", "name": n, "start_s": 0.0,
                      "dur_s": ms / 1e3, "launch": "cudaLaunchKernel"}
                     for n, ms in ops]}
    run = types.SimpleNamespace(trace=trace, requests=2)
    assert _reader("pass2_ms.decode")(run) == pytest.approx(3.25 / 2)
    trace["ops"] = trace["ops"][:2]
    assert _reader("pass2_ms.decode")(run) is None


def test_deferred_per_byte_reads_the_counter():
    """The roots' deferred bytes over the decoded bytes; None where no
    root counted any (the plain versions, or a program without the
    counter)."""
    with profiling.recording():
        for deferred in (300, 500):
            with profiling.span("decompress_frame", "host"):
                profiling.count("lz_decode.deferred_bytes", deferred)
    run = types.SimpleNamespace(requests=2, out_bytes=4000)
    assert _reader("deferred_per_byte.decode")(run) == pytest.approx(0.2)
    profiling.reset()
    with profiling.recording():
        with profiling.span("decompress_frame", "host"):
            profiling.count("lz_decode.chains", 1)
    run = types.SimpleNamespace(requests=1, out_bytes=4000)
    assert _reader("deferred_per_byte.decode")(run) is None


def test_encode_cell_is_correct_with_its_span_metrics(monkeypatch):
    monkeypatch.setattr(tracing, "profile", _recorded)
    res = harness.run_cell(tiny.cell(ENCODE, TRACED[ENCODE]), SEED, 0.05,
                           True, "cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["reference_blocks_wrong"]["value"] == 0
    for metric in ("emit_ms.encode", "host_pct.encode",
                   "staged_per_byte.encode"):
        assert res["metrics"][metric]["value"] > 0, metric
