"""Compressed bytes per 100 input bytes over every call of the window."""


def read(run):
    return 100.0 * run.out_bytes / run.in_bytes
