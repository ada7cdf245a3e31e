"""The HBM floor of the input and compressed bytes as a share of the
device time of every kernel of the traced window (roofline.py)."""

from h100_bench import roofline


def read(run):
    return roofline.pct(run)
