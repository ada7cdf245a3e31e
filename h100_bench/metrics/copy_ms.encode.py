"""Device time of the copies (host to device and back) per call, ms."""

from h100_bench import tracing


def read(run):
    if run.trace is None or not run.requests:
        return None
    return tracing.kind_s(run.trace, "memcpy") / run.requests * 1e3
