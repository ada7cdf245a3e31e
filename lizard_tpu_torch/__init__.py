"""lizard_tpu_torch: the PyTorch/CUDA port of lizard_tpu, the Lizard (LZ5)
codec, for an NVIDIA H100.

It stands beside the JAX package and imports nothing of it (nor JAX). The
layout mirrors lizard_tpu, so each module's counterpart has the same name:

- ``format``             -- formats as pure data (constants, level table)
- ``errors``             -- CorruptError, HufError
- ``runtime``            -- ctypes binding over the shared native runtime
- ``ops.split``          -- host split of streams into a flat block batch
- ``ops.lane_decode``    -- LZ decode: the CUDA kernel csrc/lz_decode.cu,
                            its wrapper and its plain PyTorch version
- ``frame`` / ``api``    -- frame container and one-shot entry points

Every entry point runs on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from lizard_tpu_torch.api import (  # noqa: F401
    compress,
    decompress,
    decompress_frame,
)
