"""lizard_tpu_torch: the PyTorch/CUDA port of lizard_tpu, the Lizard (LZ5)
codec, for an NVIDIA H100.

It stands beside the JAX package and imports nothing of it (nor JAX). The
layout mirrors lizard_tpu, so each module's counterpart has the same name:

- ``format``             -- formats as pure data (constants, level table)
- ``errors``             -- CorruptError, HufError
- ``runtime``            -- ctypes binding over the shared native runtime
- ``device``             -- the device rule (resolve_device)
- ``ref``                -- the bit-exact oracle, serial Python on the
                            host (the lizard_tpu/ref counterparts):
                            ``block_decode``, ``block_encode`` with
                            ``parsers``, ``parser_optimal`` and ``price``,
                            and the Huff0 codec ``huf`` / ``huf_encode``
                            (whose headers and tables the device paths use)
- ``ops.split``          -- host split of streams into a flat block batch
- ``ops.huf128``         -- Huff0 decode: the CUDA kernel csrc/huf_decode.cu,
                            its host plan, wrapper and plain PyTorch version
- ``ops.lane_decode``    -- LZ decode: the CUDA kernel csrc/lz_decode.cu,
                            its wrapper and its plain PyTorch version
- ``ops.fuse``           -- Huff0 then LZ decode on the device, no host
                            round trip between them (levels 30-49)
- ``ops.pallas_decode``  -- one stream, or a batch in one output slot per
                            block, decoded by the LZ kernel
                            (decompress_pallas, decode_batch_pallas)
- ``ops.lane_huf``       -- a batch of Huff0 blobs decoded by the Huff0
                            kernel (huf_decompress_lanes)
- ``ops.enc_lanes``      -- the device encoder: the CUDA kernels
                            csrc/enc_match.cu, csrc/enc_chain.cu and
                            csrc/enc_parse.cu, their wrappers and plain
                            PyTorch versions, native emission, containers
- ``ops.enc_huf``        -- Huff0 encode: the CUDA kernel csrc/huf_encode.cu,
                            its host plan, wrapper and plain PyTorch version
- ``ops.decode``         -- the all-XLA batched decoder in plain PyTorch
                            operations (decode_batch, decompress_xla)
- ``ops.encode_tpu``     -- the all-XLA fastLZ4 encoder in plain PyTorch
                            operations (encode_blocks_tpu,
                            encode_streams_tpu)
- ``parallel.pipeline``  -- decode and encode over a list of devices, one
                            shard each (decode_streams_sharded(_lanes),
                            decode_frame_sharded, encode_blocks_sharded)
- ``parallel.multihost`` -- the torch.distributed group and
                            decode_streams_global (per-block lengths
                            all-gathered on the device)
- ``utils.profiling``    -- spans at the layer boundaries (recorded under
                            torch.profiler or recording()), counters of
                            staged bytes and kernel launches, traces
- ``entry``              -- the all-XLA decode step and a dry run of every
                            sharded path
- ``utils.xxh``          -- xxh32 and xxh64 from the specification
- ``frame`` / ``api``    -- frame container and one-shot entry points
                            (compress(backend="gpu", "native" or "ref"),
                            compress_frame(backend="gpu" or "ref"),
                            compress_frame_lanes, compress_frame_tpu,
                            decompress(backend="gpu", "xla" or "ref"),
                            decompress_frame and decompress_frames:
                            linked, independent and skippable frames), and
                            the incremental FrameEncoder (backend="gpu",
                            "native" or "ref") and FrameDecoder (input in
                            pieces, decoded on the card an update at a time)
- ``streaming``          -- CompressStream (the oracle's streaming encoder,
                            host), DecompressStream, decompress_using_dict
                            and decompress_partial (on the card: each stream
                            one chain headed by the history or dictionary)
- ``cli``                -- the `lizard` command line
                            (python -m lizard_tpu_torch.cli; 64 KB loop,
                            LIZARD_TPU_BACKEND=gpu, native or ref)
- ``tools``              -- datagen_cli and fullbench
                            (python -m lizard_tpu_torch.tools.<name>)

Every entry point runs on the card unless the caller passes device="cpu";
the oracle runs on the host, reached only through backend="ref" or its own
modules.
Decoding at levels 30-49 runs both kernels on the card (entropy="gpu", the
default); entropy="host" decodes the Huffman stage with the native Huff0.
Compressing (``compress``, backend="gpu" by default, levels 10-49) finds
matches and parses on the card, emits the codewords on the host, and at
levels 30-49 packs the Huff0 bitstreams of every block on the card
(entropy="gpu", the default of encode_blocks_lanes and
compress_frame_lanes; entropy="host" uses the native Huff0).
"""

__version__ = "0.1.0"

from lizard_tpu_torch.api import (  # noqa: F401
    compress,
    compress_frame,
    decompress,
    decompress_frame,
)
from lizard_tpu_torch.frame import (  # noqa: F401
    FrameDecoder,
    FrameEncoder,
    compress_frame_lanes,
    compress_frame_tpu,
    decompress_frame_lanes,
    decompress_frames,
)
from lizard_tpu_torch.ops.enc_huf import huf_compress_batch  # noqa: F401
from lizard_tpu_torch.ops.enc_lanes import (  # noqa: F401
    encode_blocks_lanes,
    encode_streams_lanes,
)
from lizard_tpu_torch.parallel.multihost import (  # noqa: F401
    decode_streams_global,
)
from lizard_tpu_torch.streaming import (  # noqa: F401
    CompressStream,
    DecompressStream,
    decompress_partial,
    decompress_using_dict,
)
from lizard_tpu_torch.parallel.pipeline import (  # noqa: F401
    decode_frame_sharded,
    decode_streams_sharded,
    decode_streams_sharded_lanes,
    encode_blocks_sharded,
)
