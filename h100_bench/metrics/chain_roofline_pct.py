"""The HBM floor of the window's input bytes, read once, as a share of the
device time of the program's hash-chain walk (chain_walk.py)."""

from h100_bench import chain_walk


def read(run):
    return chain_walk.roofline_pct(run)
