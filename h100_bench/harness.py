"""One run of one benchmark cell: set-up, a closed-loop window, the check of
every answer, and the cell's metrics.

Everything that belongs to one cell is data found by name:

- BENCHMARK.json names the cell's configuration (whose `file` holds the
  level, the block layout and the corpus recipe) and its traffic mix;
- traffic/<name>.json holds the request form, the entry called and its
  arguments, the request size, the order of inputs, the client count and
  the warm-up;
- metrics/<name>.py reads one metric, end-to-end or per-layer, from a
  `Run` (host-clock record of the window, byte counts, the trace summary).

Request forms (a traffic file's "input"), each made from the corpus that
the configuration's recipe builds from the seed:

- "streams": a request is the list of block streams of one `request_bytes`
  piece, each `block_bytes` block compressed alone at the configuration's
  level by the benchmark's frozen native encoder; an answer is the list of
  decoded blocks;
- "frame": a request is one blockIndependent frame of a piece, written by
  the benchmark's frame writer (`block_size_id`, content checksum); an
  answer is the piece;
- "raw": a request is a piece; an answer is a frame of it, which the check
  parses, decodes with the frozen native frame decoder and, on a sample of
  its blocks drawn from the seed, with the plain reference.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
import types

import numpy as np

from h100_bench import corpus, frames, native
from h100_bench.reference import frame as ref_frame

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lizard_tpu")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(cell: str, trace: bool, root: str = ROOT) -> dict:
    """The cell's workload entry, configuration, traffic and the metric
    entries it reports (end-to-end without a trace, per-layer with one),
    all found by name under `root`."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench_dir = os.path.join(root, os.path.basename(HERE))

    def reports(m):
        return cell in m["workloads"] if "workloads" in m else True
    e2e = [m for m in spec["end_to_end"] if reports(m)]
    if trace:
        names = {m["name"] for m in e2e}
        chosen = [m for m in spec["per_layer"]
                  if (cell in m["workloads"] if "workloads" in m
                      else m["moves"] in names)]
    else:
        chosen = e2e
    return {"workload": w,
            "config": _load_json(os.path.join(root, cfg["file"])),
            "traffic": _load_json(os.path.join(bench_dir, "traffic",
                                               w["traffic"] + ".json")),
            "metrics": [(m["name"], m["unit"]) for m in chosen],
            "metric_dir": os.path.join(bench_dir, "metrics")}


def reader(metric_dir: str, name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(metric_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry(traffic: dict):
    """The program's function that a request calls ("module:function")."""
    mod, fn = traffic["entry"].split(":")
    return getattr(importlib.import_module(mod), fn)


def entry_kwargs(traffic: dict, config: dict, device: str) -> dict:
    subst = {"$level": config["level"], "$device": device}
    return {k: subst.get(v, v) if isinstance(v, str) else v
            for k, v in traffic["args"].items()}


def prepare(config: dict, traffic: dict, seed: int) -> types.SimpleNamespace:
    """The requests and their expected answers, made from the seed."""
    data = corpus.build(seed, config["corpus_bytes"],
                        config["corpus_part_bytes"], config["corpus_kinds"])
    size = traffic["request_bytes"]
    pieces = [data[p:p + size] for p in range(0, len(data), size)]
    form, level = traffic["input"], config["level"]
    if form == "streams":
        bb = config["block_bytes"]
        expected = [[p[q:q + bb] for q in range(0, len(p), bb)]
                    for p in pieces]
        inputs = [[native.compress(b, level) for b in blocks]
                  for blocks in expected]
        sizes = [sum(map(len, s)) for s in inputs]
    elif form == "frame":
        expected = pieces
        inputs = [frames.write_frame(p, level, traffic["block_size_id"])
                  for p in pieces]
        sizes = [len(f) for f in inputs]
    elif form == "raw":
        expected = inputs = pieces
        sizes = [len(p) for p in pieces]
    else:
        raise ValueError(f"unknown request form {form!r}")
    return types.SimpleNamespace(inputs=inputs, expected=expected,
                                 sizes=sizes)


def order(traffic: dict, n_inputs: int, seed: int):
    """The index of each request's input, endless: "rotate" takes them in
    turn, going on from where the warm-up left off, "uniform" draws each
    from the seed."""
    if traffic["order"] == "rotate":
        k = traffic["warmup"]
        while True:
            yield k % n_inputs
            k += 1
    elif traffic["order"] == "uniform":
        rng = np.random.default_rng([seed % (1 << 64), 1])
        while True:
            yield from rng.integers(0, n_inputs, 4096).tolist()
    else:
        raise ValueError(f"unknown order {traffic['order']!r}")


def _answer_bytes(form: str, answer) -> int:
    return sum(map(len, answer)) if form == "streams" else len(answer)


def _diff(got, want) -> int:
    """Bytes that differ between two answers, a length difference counted
    as that many bytes."""
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, m)
    b = np.frombuffer(want, np.uint8, m)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


class Checker:
    """The correctness check, fed each answer as the window returns it and
    compared at once, outside the window's time (see run_cell), so no
    answer is kept and the program's memory behaves as a caller's that
    consumes its answers. Its numbers: requests that raised; answers
    (streams or frames) that are not what the request's input holds, with
    the bytes they miss by; for "raw", also frames that the reference's
    container parse or the frozen native decoder refuses or that decode to
    other bytes, and frame blocks that the plain reference decodes to
    other bytes or refuses: one block drawn from the seed of each of the
    window's first `reference_blocks` frames, decoded after the window."""

    def __init__(self, form: str, traffic: dict, work, seed: int):
        self.form, self.traffic, self.work = form, traffic, work
        self.rng = np.random.default_rng([seed % (1 << 64), 2])
        self.n = {"requests_failed": 0, "answers_wrong": 0,
                  "bytes_wrong": 0}
        self.bad_requests = 0
        self.sampled = []           # (payload block, its expected bytes)

    def failed(self) -> None:
        self.n["requests_failed"] += 1
        self.bad_requests += 1

    def _wrong(self, got, want) -> None:
        self.n["answers_wrong"] += 1
        self.n["bytes_wrong"] += _diff(got, want)

    def take(self, idx: int, answer) -> None:
        before = self.n["answers_wrong"]
        want = self.work.expected[idx]
        if self.form == "streams":
            n = max(len(answer), len(want))
            for k in range(n):
                got = answer[k] if k < len(answer) else b""
                exp = want[k] if k < len(want) else b""
                if got != exp:
                    self._wrong(got, exp)
        elif self.form == "raw":
            self._take_frame(answer, want)
        elif answer != want:
            self._wrong(answer, want)
        self.bad_requests += self.n["answers_wrong"] > before

    def _take_frame(self, answer: bytes, want: bytes) -> None:
        try:
            parsed = ref_frame.parse(answer, native.xxh32)
        except ref_frame.FrameError:
            parsed = None
        if parsed is None or (
                self.traffic["args"].get("content_checksum", True)
                and parsed["checksum"] != native.xxh32(want)):
            self._wrong(b"", want)
            return
        got = native.decompress_frame(answer, len(want) + 1) or b""
        if got != want:
            self._wrong(got, want)
        if len(self.sampled) < self.traffic["reference_blocks"] \
                and parsed["blocks"]:
            k = int(self.rng.integers(len(parsed["blocks"])))
            size = parsed["block_size"]
            self.sampled.append((parsed["blocks"][k],
                                 want[k * size:(k + 1) * size], size))

    def finish(self) -> dict:
        """The compared numbers; runs the plain reference on the sample."""
        out = dict(self.n)
        if self.form == "raw":
            wrong = 0
            for block, want, size in self.sampled:
                try:
                    got = ref_frame.decode_block(block, size)
                except ValueError:
                    got = None
                wrong += got != want
            out["reference_blocks_wrong"] = wrong
        return out


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fn=None,
             t_start: float | None = None) -> dict:
    """One run of a resolved cell (see `resolve`): set-up, the window, the
    check and the metrics. `fn` replaces the program's entry (the control
    and the planted faults); `t_start` is the monotonic time that set-up
    counts from, by default the start of this process. Returns the result fields (the contract's line without
    `device`) plus "checks" and "forbidden" (modules of JAX or of the JAX
    package loaded by then)."""
    import torch
    if t_start is None:
        t_start = time.monotonic() - _process_age_s()
    config, traffic = cell["config"], cell["traffic"]
    if traffic["clients"] != 1 or traffic["loop"] != "closed":
        raise ValueError("the harness drives one closed-loop client")
    call = fn or entry(traffic)
    kw = entry_kwargs(traffic, config, device)
    form = traffic["input"]
    work = prepare(config, traffic, seed)
    n = len(work.inputs)
    for k in range(traffic["warmup"]):
        try:
            call(work.inputs[k % n], **kw)
        except Exception as e:          # the window counts the failures
            _log(f"warm-up request {k} failed: {e!r}")
    if device != "cpu":
        torch.cuda.synchronize()
    picks = order(traffic, n, seed)
    checker = Checker(form, traffic, work, seed)
    lat = []
    in_bytes = out_bytes = 0
    setup_s = time.monotonic() - t_start
    mark = contextlib.nullcontext
    if trace:
        from torch.profiler import record_function

        from h100_bench import tracing

        def mark():
            return record_function(tracing.CHECK)

    def window():
        """Requests until `seconds` of window time have passed. Each answer
        is checked as it comes and then dropped; the checks' time is cut
        out of the window (and, in a trace, out of its timeline)."""
        nonlocal in_bytes, out_bytes
        t0 = time.perf_counter()
        cut = 0.0
        while True:
            idx = next(picks)
            a = time.perf_counter()
            try:
                answer = call(work.inputs[idx], **kw)
            except Exception as e:      # a failed request is counted
                _log(f"request {len(lat)} failed: {e!r}")
                answer = None
            b = time.perf_counter()
            lat.append(b - a)
            in_bytes += work.sizes[idx]
            with mark():
                if answer is None:
                    checker.failed()
                else:
                    out_bytes += _answer_bytes(form, answer)
                    checker.take(idx, answer)
                    answer = None
            if b - t0 - cut >= seconds:
                return b - t0 - cut
            cut += time.perf_counter() - b

    summary = None
    if trace:
        with tracing.profile() as held:
            window_s = window()
        summary = held["summary"]
        _log(f"trace: {held['events']} profiler events, "
             f"{len(summary['ops'])} device operations in the window")
    else:
        window_s = window()
    mem_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    forbidden = sorted({m.split(".")[0] for m in sys.modules}
                       & set(FORBIDDEN))
    t_check = time.monotonic()
    checks = checker.finish()
    _log(f"reference sample took {time.monotonic() - t_check:.1f} s")
    run = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, latencies_s=lat,
        requests=len(lat), in_bytes=in_bytes, out_bytes=out_bytes,
        trace=summary, device_kind=(torch.cuda.get_device_name()
                                    if device != "cpu" else "cpu"))
    metrics = {}
    for name, unit in cell["metrics"]:
        value = reader(cell["metric_dir"], name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    lat_ms = sorted(x * 1e3 for x in lat)
    _log(f"window {window_s:.3f} s, {len(lat)} requests, latency ms "
         f"median {statistics.median(lat_ms):.3f} max {lat_ms[-1]:.3f}, "
         f"in {in_bytes} B, out {out_bytes} B, setup {setup_s:.3f} s")
    result = {"correct": all(v <= 0 for v in checks.values()),
              "attempted": len(lat), "failed": checker.bad_requests,
              "metrics": metrics, "memory_peak_bytes": mem_peak,
              "checks": {k: {"value": v, "limit": 0}
                         for k, v in checks.items()},
              "forbidden": forbidden}
    if summary is not None:
        result["busy_s"] = tracing.busy_s(summary)
        result["window_s"] = summary["window_s"]
        result["breakdown"] = tracing.breakdown(summary)
    return result
