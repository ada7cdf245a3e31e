"""Kernels, copies and fills on the card per request."""

from h100_bench import tracing


def read(run):
    if run.trace is None or not run.requests:
        return None
    return tracing.count(run.trace) / run.requests
