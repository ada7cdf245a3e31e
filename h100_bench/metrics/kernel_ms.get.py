"""Kernel device time per request, ms."""

from h100_bench import tracing


def read(run):
    if run.trace is None or not run.requests:
        return None
    return tracing.kind_s(run.trace, "kernel") / run.requests * 1e3
