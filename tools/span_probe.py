"""The port's spans (lizard_tpu_torch/utils/profiling.py) on a benchmark
cell, on the card. Run from the root of a checkout:

    python3 tools/span_probe.py record --workload <cell> --seed <n> \
        --seconds <s>

runs the cell exactly as `python3 h100_bench/run.py ... --trace 0` does,
with the spans recording in memory the whole time (profiling.recording(),
no profiler): its end-to-end metrics beside a plain run's give what
recording costs. It prints run.py's result line, then one JSON line of the
spans recorded per request and in all.

    python3 tools/span_probe.py check --workload <cell> --seed <n> \
        [--requests 3] [--device cuda]

makes the cell's inputs, warms up, then profiles a few requests as
h100_bench/tracing.py does (CPU and CUDA activities) and checks in the
exported Chrome trace that every CUDA runtime call that issued a device
operation lies inside a `lizard.*` span of kind "device" on its thread.
It prints one JSON line: the calls inside and outside such spans, by the
innermost span around each, the kernels launched in each span (by
function name), and the annotations beside the records. Exits 1 if a call
lies outside.
"""

import argparse
import collections
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRACE = os.path.join(ROOT, ".cache", "span_probe", "trace.json")


def record(argv) -> int:
    from h100_bench import run                  # pins malloc first
    from lizard_tpu_torch.utils import profiling
    with profiling.recording():
        rc = run.main(argv)
    recs = profiling.records()
    roots = sum(r.parent is None for r in recs)
    print(json.dumps({"spans": len(recs), "roots": roots,
                      "spans_per_request": len(recs) / max(roots, 1),
                      "spans_dropped": profiling.counters()["spans_dropped"]}),
          flush=True)
    return rc


def _inside(events, tid, t, kinds):
    """The innermost lizard.* annotation of thread `tid` around time t
    (its name and kind), or None."""
    best = None
    for e in events.get(tid, ()):
        if e["ts"] <= t <= e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    if best is None:
        return None
    name = best["name"][len("lizard."):]
    return name, kinds.get(name)


def _kernel(name: str) -> str:
    """A kernel's function name, without namespaces, template arguments or
    argument list ("(anonymous namespace)::link(long const*, ...)" ->
    "link")."""
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, 1)[0].split("::")[-1].split()[-1]


def check(argv) -> int:
    p = argparse.ArgumentParser(prog="span_probe.py check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity

    from h100_bench import harness
    from lizard_tpu_torch.utils import profiling
    cell = harness.resolve(args.workload, False)
    config, traffic = cell["config"], cell["traffic"]
    call = harness.entry(traffic)
    kw = harness.entry_kwargs(traffic, config, args.device)
    work = harness.prepare(config, traffic, args.seed)
    for k in range(traffic["warmup"]):
        call(work.inputs[k % len(work.inputs)], **kw)
    if args.device != "cpu":
        torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for k in range(args.requests):
            call(work.inputs[k % len(work.inputs)], **kw)
        if args.device != "cpu":
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(TRACE), exist_ok=True)
    prof.export_chrome_trace(TRACE)
    with open(TRACE) as f:
        events = json.load(f)["traceEvents"]
    os.remove(TRACE)
    recs = profiling.records()
    kinds = {r.name: r.kind for r in recs}
    spans = collections.defaultdict(list)
    annotations = 0
    device_corr = set()
    kernel_of = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith(profiling.PREFIX):
            spans[e["tid"]].append(e)
            annotations += 1
        elif e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device_corr.add(e.get("args", {}).get("correlation"))
            if e["cat"] == "kernel":
                kernel_of[e.get("args", {}).get("correlation")] = \
                    _kernel(e["name"])
    by_span = collections.Counter()
    kernels = collections.Counter()
    outside = collections.Counter()
    for e in events:
        if (e.get("ph") != "X"
                or e.get("cat") not in ("cuda_runtime", "cuda_driver")
                or e.get("args", {}).get("correlation") not in device_corr):
            continue
        at = _inside(spans, e["tid"], e["ts"] + e["dur"] / 2, kinds)
        if at is None or at[1] != "device":
            outside[f"{e['name']} in {at[0] if at else 'no span'}"] += 1
        else:
            by_span[f"{e['name']} in {at[0]}"] += 1
            corr = e.get("args", {}).get("correlation")
            if corr in kernel_of:
                kernels[f"{kernel_of[corr]} in {at[0]}"] += 1
    print(json.dumps({"workload": args.workload, "requests": args.requests,
                      "records": len(recs), "annotations": annotations,
                      "calls_in_device_spans": sum(by_span.values()),
                      "calls_outside": sum(outside.values()),
                      "by_span": dict(sorted(by_span.items())),
                      "kernels": dict(sorted(kernels.items())),
                      "outside": dict(sorted(outside.items()))}),
          flush=True)
    return 1 if outside or annotations != len(recs) else 0


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("record", "check"):
        print(__doc__, file=sys.stderr)
        return 2
    return (record if sys.argv[1] == "record" else check)(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
