# Frozen copy of lizard_tpu_torch/errors.py at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea, with its imports
# pointing into h100_bench.reference. Later changes to the program do not reach it.
"""Shared error hierarchy (a copy of lizard_tpu/errors.py), the role of the
reference's error system (lib/lizard_frame_static.h:57-76 error enum; block
layer's negative return codes, lib/lizard_decompress.h:63-72).

CorruptError is the single "input data is invalid" type: every decoder
tier (host split, native bindings, the CUDA kernel's status) raises it -- or
a subclass -- for any malformed input, so callers can catch one exception
for the whole corruption class, like `LizardF_isError` covers every error
code.
"""


class CorruptError(ValueError):
    """Malformed or truncated compressed input (any layer)."""


class HufError(CorruptError):
    """Malformed Huff0/FSE entropy payload (lib/entropy error codes)."""
