"""Bytes that pass 2 of the program's LZ decode resolved per decoded byte,
B/B: the program's lz_decode.deferred_bytes counter
(lizard_tpu_torch/ops/lane_decode.py, counted on the card while spans
record) over the calls of the traced window, over the decoded bytes
returned. None without records (a --trace 0 run), with a root count other
than the window's requests, with dropped spans, and where no call counted
a deferred byte (a program without the counter, or no chain in the
window with a second block)."""

NAME = "lz_decode.deferred_bytes"


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
    if not run.out_bytes or not any(NAME in r.counts for r in roots):
        return None
    return sum(r.counts.get(NAME, 0) for r in roots) / run.out_bytes
