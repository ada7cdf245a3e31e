"""Bytes staged to the card and read back per input byte, B/B: the
program's h2d_bytes and d2h_bytes counters (lizard_tpu_torch/utils/
profiling.py) over the calls of the traced window, over the input bytes
compressed: the packed blocks, the tokens back, the Huff0 stage's
streams and words."""


def read(run):
    try:
        from lizard_tpu_torch.utils import profiling
        recs = profiling.records()
        dropped = profiling.counters()["spans_dropped"]
    except (ImportError, AttributeError):
        return None                 # a program without spans
    roots = [r for r in recs if r.parent is None]
    if not recs or len(roots) != run.requests or dropped:
        return None
    staged = sum(r.counts.get("h2d_bytes", 0) + r.counts.get("d2h_bytes", 0)
                 for r in roots)
    return staged / run.in_bytes if run.in_bytes else None
