"""Huff0 decode of a batch of blobs: the port of lizard_tpu/ops/lane_huf.py
(huf_decompress_lanes). The module keeps the JAX module's name so a reader
finds it.

Its Pallas kernel, _huf_lane_kernel, decodes the four bitstreams of every
blob with a 2048-entry table (tableLog 11) per stream, scheduled onto
slots. That is the contract of the Huff0 kernel csrc/huf_decode.cu
(ops/huf128.py::huf_decode), so it is folded into it: this function is
huf128.huf_decompress_128 with B9's input rule. None of the TPU layout is
ported: no byte-reversed pool, slots, supers, task list or 16-tile tables.

Where the JAX function fails by its layout or a fault, the port does what
the format says: a tableLog-12 blob decodes right (the JAX table expansion
at lane_huf.py:355 shifts by -1 there and reads entry 0 for every symbol);
there is no cap of MAX_TASKS bitstreams per slot; and a bitstream that is
not consumed exactly, or lacks its end mark, raises HufError naming the
blob and segment (the TPU kernel supplies zero bits past the end and never
checks).
"""

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.errors import HufError
from lizard_tpu_torch.ops.huf128 import huf_decompress_128


def huf_decompress_lanes(blobs, device=None) -> list[bytes]:
    """Decode a batch of Huff0 blobs [(blob bytes, decoded size)] on
    `device` (the card unless device="cpu") in one huf_decode launch;
    returns the decoded bytes of each. A blob no shorter than its decoded
    size raises HufError, as in the JAX function (it takes no stored
    blob); a 1-byte blob is RLE and is filled on the host, and a batch of
    only those launches nothing."""
    dev = resolve_device(device)
    for i, (blob, dst_size) in enumerate(blobs):
        if len(blob) >= dst_size:
            raise HufError(f"blob {i}: not a compressed huf blob ("
                           f"{len(blob)} bytes for {dst_size})")
    return huf_decompress_128(blobs, device=dev)
