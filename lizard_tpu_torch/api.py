"""Top-level one-shot API of the port (the counterpart of lizard_tpu/api.py):
block-stream compression through the device encoder (the default) or the
native encoder, and block-stream and frame decompression on the card (the
CUDA kernels, or backend="xla": the all-XLA decoder in plain PyTorch
operations); device=None means "cuda", device="cpu" the plain route."""

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import LIZARD_DEFAULT_CLEVEL
from lizard_tpu_torch import frame
from lizard_tpu_torch.ops.decode import decompress_xla
from lizard_tpu_torch.ops.enc_lanes import encode_streams_lanes
from lizard_tpu_torch.ops.lane_decode import decompress_lanes


def compress(data: bytes, level: int = LIZARD_DEFAULT_CLEVEL,
             backend: str = "gpu", max_out: int | None = None,
             device=None) -> bytes:
    """One-shot block-stream compression (Lizard_compress equivalent).

    backend="gpu" (the default): the device encoder (ops/enc_lanes.py) on
    `device`, the card unless device="cpu" (then the plain PyTorch
    versions), levels 10-49, Huff0 stage included at 30-49; the
    counterpart of the JAX package's backend="tpu", byte-identical to it.
    backend="native": the native C++ encoder on the host, all 40 levels,
    valid streams, not byte-identical to liblizard. The bit-exact "ref"
    encoder waits for the port of the oracle. Raises ValueError when the
    stream exceeds max_out."""
    if backend == "native":
        return runtime.compress(data, level, max_out=max_out)
    if backend != "gpu":
        raise NotImplementedError(
            f"backend {backend!r}: only 'native' and 'gpu' are ported")
    if not 10 <= level <= 49:
        raise ValueError("backend='gpu' supports levels 10-49")
    out = encode_streams_lanes([data], level=level, device=device)[0]
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
    the decoded size there."""
    if backend == "xla":
        return decompress_xla(data, max_out, device)
    if backend != "gpu":
        raise NotImplementedError(
            f"backend {backend!r}: only 'gpu' and 'xla' are ported")
    out = decompress_lanes([data], device=device)[0]
    if max_out is not None and len(out) > max_out:
        raise CorruptError("output exceeds max_out")
    return out


def decompress_frame(data: bytes, device=None, **kw) -> bytes:
    """Decode one frame on `device` (frame.decompress_frame): linked or
    blockIndependent, any level, or a skippable frame (b"")."""
    return frame.decompress_frame(data, device=device, **kw)
