"""Share of the traced window spent in the program's host work, %: the
self time of every `host` span and of every root span (the Python glue
around the stages; lizard_tpu_torch/utils/profiling.py) over the window."""


def read(run):
    try:
        from lizard_tpu_torch.utils import profiling
        recs, self_ns = profiling.records(), profiling.self_ns
        dropped = profiling.counters()["spans_dropped"]
    except (ImportError, AttributeError):
        return None                 # a program without spans
    roots = [r for r in recs if r.parent is None]
    if not recs or len(roots) != run.requests or dropped:
        return None
    own = self_ns(recs)
    host = sum(s for r, s in zip(recs, own)
               if r.kind == "host" or r.parent is None)
    return 100.0 * host / (run.window_s * 1e9)
