"""The floor of a window's work on the card's memory: the bytes the work
needs, whatever implements it (compressed bytes read once plus decoded
bytes written once; for encoding, input bytes read once plus compressed
bytes written once), over the card's published HBM rate (peaks.json, by
the name torch gives the card). Never counted from the tensors the program
stages, so a change of layout cannot move the yardstick."""

import json
import os

from h100_bench import tracing

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def hbm_bytes_per_s(kind: str) -> float | None:
    with open(_PEAKS) as f:
        entry = json.load(f).get(kind)
    return entry["hbm_bytes_per_s"] if entry else None


def pct(run) -> float | None:
    """The window's HBM floor as a share of the device time of all its
    kernels; None without a trace, a known card or a kernel."""
    peak = hbm_bytes_per_s(run.device_kind)
    if run.trace is None or peak is None:
        return None
    kernel_s = tracing.kind_s(run.trace, "kernel")
    if kernel_s <= 0:
        return None
    return 100.0 * (run.in_bytes + run.out_bytes) / peak / kernel_s
