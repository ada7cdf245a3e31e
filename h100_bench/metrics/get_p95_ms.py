"""The 95th percentile of the latency of every request of the window,
in ms (host clock around each call)."""

import statistics


def read(run):
    lat = run.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
