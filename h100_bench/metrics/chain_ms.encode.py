"""Device ms per call in the program's hash-chain walk (chain_walk.py:
the kernel chain_walk_kernel of lizard_tpu_torch/csrc/enc_chain.cu), over
the calls of the traced window. None without a trace or without the
kernel in it (levels below 46 walk no chain)."""

from h100_bench import chain_walk


def read(run):
    walk_s = chain_walk.kernel_s(run)
    if walk_s is None or not run.requests:
        return None
    return walk_s / run.requests * 1e3
