"""Device ms per call in pass 2 of the program's LZ decode: the kernels
`link`, `jump` and `compact` of lizard_tpu_torch/csrc/lz_decode.cu, which
resolve the matches of a chain's later inner blocks that reach into
earlier ones. Matched by the trace's kernel name up to its argument list,
with any namespace before it. None without a trace or without such a
kernel in it (a batch of one-block chains launches none)."""

import re

from h100_bench import tracing

PASS2 = re.compile(r"(?:^|[\s:])(link|jump|compact)\(")


def read(run):
    if run.trace is None or not run.requests:
        return None
    ops = [op for op in run.trace["ops"]
           if op["kind"] == "kernel" and PASS2.search(op["name"])]
    if not ops:
        return None
    return sum(op["dur_s"] for op in ops) / run.requests * 1e3
