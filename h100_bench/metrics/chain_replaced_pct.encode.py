"""The share of positions with a candidate whose match the program's
hash-chain walk replaced with a longer one, %: 100 times the program's
chain_walk.replaced counter over its chain_walk.positions counter
(lizard_tpu_torch/ops/enc_lanes.py, counted while spans record), over the
calls of the traced window. None without records (a --trace 0 run), with
a root count other than the window's requests, with dropped spans, and
where no call counted a position (a program without the counters, or a
level that walks no chain)."""

POSITIONS, REPLACED = "chain_walk.positions", "chain_walk.replaced"


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
    positions = sum(r.counts.get(POSITIONS, 0) for r in roots)
    if not positions:
        return None
    return 100.0 * sum(r.counts.get(REPLACED, 0) for r in roots) / positions
