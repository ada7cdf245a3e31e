"""Host ms per call in the host split and the Huff0 plan: the self time of
the program's `split` and `plan` spans (lizard_tpu_torch/utils/
profiling.py), recorded over the traced window, per call."""

NAMES = ("split", "plan")


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
    return sum(s for r, s in zip(recs, own)
               if r.name in NAMES) / len(roots) / 1e6
