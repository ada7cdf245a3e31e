"""The device time of the program's hash-chain walk (the kernel
`chain_walk_kernel` of lizard_tpu_torch/csrc/enc_chain.cu, levels 46-49)
in a traced window, and the floor of its work on the card's memory: the
window's input bytes read once at the card's published HBM rate
(peaks.json), the rule of roofline.py, which counts the work and never
the tensors the program stages (the candidate maps), so that a change of
the kernel's layout cannot move the yardstick."""

import re

from h100_bench import roofline

# The kernel's trace name up to its template or argument list, with any
# namespace before it; the profiling instance has the same name.
KERNEL = re.compile(r"(?:^|[\s:])chain_walk_kernel[<(]")


def kernel_s(run) -> float | None:
    """Seconds of the window's chain_walk kernels; None without a trace or
    without such a kernel in it."""
    if run.trace is None:
        return None
    ops = [op for op in run.trace["ops"]
           if op["kind"] == "kernel" and KERNEL.search(op["name"])]
    return sum(op["dur_s"] for op in ops) if ops else None


def roofline_pct(run) -> float | None:
    """The window's input bytes read once at the HBM rate, as a share of
    chain_walk's device time; None without a trace, a known card or the
    kernel."""
    peak = roofline.hbm_bytes_per_s(run.device_kind)
    walk_s = kernel_s(run)
    if peak is None or not walk_s:
        return None
    return 100.0 * run.in_bytes / peak / walk_s
