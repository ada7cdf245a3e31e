"""Input bytes compressed into frames returned as host bytes over the
whole window, GB/s (10^9 bytes)."""


def read(run):
    return run.in_bytes / run.window_s / 1e9
