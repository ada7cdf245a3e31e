"""Decoded bytes returned as host bytes over the whole window, GB/s
(10^9 bytes)."""


def read(run):
    return run.out_bytes / run.window_s / 1e9
