"""Top-level one-shot API of the port (the counterpart of lizard_tpu/api.py):
block-stream and frame compression through the device encoder (the
default), the native encoder or the bit-exact oracle (backend="ref"), and
block-stream and frame decompression on the card (the CUDA kernels, or
backend="xla": the all-XLA decoder in plain PyTorch operations, or
backend="ref": the oracle's serial decoder on the host); device=None means
"cuda", device="cpu" the plain route. The oracle takes no device: only
backend="ref" reaches it, and no other backend falls back to it."""

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import LIZARD_DEFAULT_CLEVEL
from lizard_tpu_torch import frame
from lizard_tpu_torch.ops.decode import decompress_xla
from lizard_tpu_torch.ops.enc_lanes import encode_streams_lanes
from lizard_tpu_torch.ops.lane_decode import decompress_lanes
from lizard_tpu_torch.ref import block_decode, block_encode


def compress(data: bytes, level: int = LIZARD_DEFAULT_CLEVEL,
             backend: str = "gpu", max_out: int | None = None,
             device=None) -> bytes:
    """One-shot block-stream compression (Lizard_compress equivalent).

    backend="gpu" (the default): the device encoder (ops/enc_lanes.py) on
    `device`, the card unless device="cpu" (then the plain PyTorch
    versions), levels 10-49, Huff0 stage included at 30-49; the
    counterpart of the JAX package's backend="tpu", byte-identical to it.
    backend="native": the native C++ encoder on the host, all 40 levels,
    valid streams, not byte-identical to liblizard. backend="ref": the
    oracle (ref/block_encode.py), byte-identical to liblizard at all 40
    levels, serial Python on the host (`device` is not used). Raises
    ValueError when the stream exceeds max_out."""
    if backend == "native":
        return runtime.compress(data, level, max_out=max_out)
    if backend == "ref":
        out = block_encode.compress(data, level)
    elif backend == "gpu":
        if not 10 <= level <= 49:
            raise ValueError("backend='gpu' supports levels 10-49")
        out = encode_streams_lanes([data], level=level, device=device)[0]
    else:
        raise NotImplementedError(
            f"backend {backend!r}: use 'gpu', 'native' or 'ref'")
    if max_out is not None and len(out) > max_out:
        raise ValueError(
            f"compressed size {len(out)} exceeds max_out {max_out}")
    return out


def decompress(data: bytes, max_out: int | None = None, device=None,
               backend: str = "gpu") -> bytes:
    """One-shot block-stream decompression (Lizard_decompress_safe) on
    `device`. backend="gpu" (the default): a one-stream decompress_lanes,
    the CUDA kernels; raises CorruptError when the output exceeds max_out.
    backend="xla": ops/decode.py::decompress_xla, the plain-PyTorch port of
    the JAX package's all-XLA decoder (its backend="jax"); max_out must be
    the decoded size there. backend="ref": the oracle's serial decoder
    (ref/block_decode.py) on the host, `device` not used."""
    if backend == "xla":
        return decompress_xla(data, max_out, device)
    if backend == "ref":
        return block_decode.decompress(data, max_out)
    if backend != "gpu":
        raise NotImplementedError(
            f"backend {backend!r}: use 'gpu', 'xla' or 'ref'")
    out = decompress_lanes([data], device=device)[0]
    if max_out is not None and len(out) > max_out:
        raise CorruptError("output exceeds max_out")
    return out


def compress_frame(data: bytes, level: int = LIZARD_DEFAULT_CLEVEL,
                   block_size_id: int = 0, block_linked: bool = False,
                   content_checksum: bool = True, content_size: bool = False,
                   backend: str = "gpu", device=None) -> bytes:
    """One-shot frame compression (LizardF_compressFrame). backend="gpu"
    (the default): frame.compress_frame_lanes on `device`, levels 10-49,
    blockIndependent frames only (block_linked=True raises ValueError).
    backend="ref": frame.compress_frame, the oracle on the host, linked or
    independent blocks, byte-equal to liblizard and to the JAX
    api.compress_frame."""
    if backend == "ref":
        return frame.compress_frame(data, level, block_size_id, block_linked,
                                    content_checksum, content_size)
    if backend != "gpu":
        raise NotImplementedError(
            f"backend {backend!r}: use 'gpu' or 'ref'")
    if block_linked:
        raise ValueError("backend='gpu' makes independent blocks only; "
                         "block_linked=True needs backend='ref'")
    return frame.compress_frame_lanes(data, level, block_size_id,
                                      content_checksum, content_size,
                                      device=device)


def decompress_frame(data: bytes, device=None, **kw) -> bytes:
    """Decode one frame on `device` (frame.decompress_frame): linked or
    blockIndependent, any level, or a skippable frame (b"")."""
    return frame.decompress_frame(data, device=device, **kw)
