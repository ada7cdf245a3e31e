"""Block decode with one fixed output slot per inner block: the port of
lizard_tpu/ops/pallas_decode.py (decode_batch_pallas, decompress_pallas).
The module keeps the JAX module's name so a reader finds it.

Its two Pallas kernels, _lz4_block_kernel and _liz_block_kernel, decode a
batch block after block (one grid step each), carrying a 64 KB halo of the
previous block in VMEM and staging LIZv1 far sources by DMA from the output
already written. That is the contract of the LZ kernel csrc/lz_decode.cu
(ops/lane_decode.py::lz_decode, family 0 = fastLZ4, 1 = LIZv1), which
decodes every chain of a batch with its window in global memory; so both are
folded into it: decode_batch_pallas is a host side over one lz_decode
launch, and decompress_pallas is the decoder's one route on one stream.
None of the TPU layout is ported: no one-byte-per-i32-lane rows, halo,
staging rows or DMA granularity.

Where the JAX functions assume well-formed input (pallas_decode.py:27-28),
the port checks it: a corrupt chain raises CorruptError (rep match with
last_off == 0 included, which the TPU kernel skips); a short non-final block
still decodes (its slot is filled by a layout step); and a match window
never crosses from one stream into the next (each stream is its own chain).
"""

import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import LIZARD_BLOCK_SIZE
from lizard_tpu_torch.ops.lane_decode import (
    decompress_lanes, lz_decode, raise_on_status, stage_batch)
from lizard_tpu_torch.ops.split import BlockBatch


def to_slots(out, block_len, chains) -> torch.Tensor:
    """An lz_decode output (each chain's bytes contiguous at its base) in
    the slot layout: block b at b * LIZARD_BLOCK_SIZE. Where every
    non-final block of each chain is a full 128 KB the two layouts are one
    and `out` comes back as it is; else the blocks move into their slots
    in a new tensor, by slices on out's device (the lengths alone come to
    the host)."""
    lens = block_len.cpu().long()
    slot = torch.arange(lens.numel(), dtype=torch.int64) * LIZARD_BLOCK_SIZE
    start = torch.empty_like(slot)
    for first, count, base in chains.cpu().tolist():
        run = lens[first:first + count]
        start[first:first + count] = base + torch.cumsum(run, 0) - run
    if torch.equal(start, slot):
        return out
    moved = torch.zeros_like(out)
    for b in range(lens.numel()):
        s, d, n = int(start[b]), int(slot[b]), int(lens[b])
        moved[d:d + n] = out[s:s + n]
    return moved


def decode_batch_pallas(batch: BlockBatch, device=None):
    """Decode a BlockBatch (either codeword family) on `device` (the card
    unless device="cpu") in one lz_decode call.

    Returns (out, block_len): out is uint8 [n_blocks * LIZARD_BLOCK_SIZE]
    on the device with block b's decoded bytes at b * LIZARD_BLOCK_SIZE
    (the JAX function's layout as bytes, not one byte per i32 lane), and
    block_len is int32 [n_blocks]. Bytes past a block's length are
    undefined. Raises CorruptError on a corrupt chain."""
    args = stage_batch(batch, resolve_device(device))
    out, block_len, status = lz_decode(**args)
    raise_on_status(batch, args["chains"].cpu(), status)
    return to_slots(out, block_len, args["chains"]), block_len


def decompress_pallas(src: bytes, max_out: int, device=None) -> bytes:
    """Decode one compressed stream (any level) on `device`: the
    decoder's one route, lane_decode.decompress_lanes (at levels 30-49
    huf_decode, then one lz_decode launch).

    Returns the decoded bytes; raises CorruptError when they exceed
    max_out, as api.decompress does. The JAX function returns
    flat[:max_out] of its padded slot output instead: padding past the
    decoded length, and a silent cut below it, both artefacts of its
    layout; the two agree at max_out == the decoded size."""
    out = decompress_lanes([src], device=device)[0]
    if len(out) > max_out:
        raise CorruptError("output exceeds max_out")
    return out
