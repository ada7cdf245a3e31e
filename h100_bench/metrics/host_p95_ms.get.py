"""The 95th percentile, over the requests of the traced window, of each
request's host time in ms: the self time of its `host` spans and of its
root span (lizard_tpu_torch/utils/profiling.py), grouped by request id."""

import statistics


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
    per = {}
    for r, s in zip(recs, own):
        if r.kind == "host" or r.parent is None:
            per[r.request] = per.get(r.request, 0) + s
    if len(per) < 2:
        return None
    return statistics.quantiles([v / 1e6 for v in per.values()], n=100,
                                method="inclusive")[94]
