"""Fused Huffman -> LZ decode: the port of lizard_tpu/ops/fuse.py. The
Huff0 kernel's output reaches the LZ kernel's stream tensors without a
host round trip.

Flow (decompress_lanes_fused):
  host:   split the streams without entropy-decoding them: every
          Huffman-coded stream is a hole of `orig` zero bytes in its flat
          stream, at its block's offset for that stream; plan the Huff0
          blobs (ops/huf128.py::prepare_huf128) with each hole as the
          destination, and fill RLE and stored blobs' holes
  device: stage the batch; huf_decode fills the holes in the staged
          flags/literals/off16/off24 tensors; lz_decode reads them, on
          the same stream; one copy of the output back

The TPU pipeline's compaction pass (fuse.py::_compact_kernel) existed
because its Huff0 kernel scattered a stream's four segments; here each
segment is decoded straight into its hole, so there is no such pass, and
none of its fallbacks: every blob kind (off16 and off24 included) and
every tableLog up to 12 takes the device path.
"""

import numpy as np
import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.ops.huf128 import (
    HufPlan, huf_decode, prepare_huf128, raise_on_status)
from lizard_tpu_torch.ops.lane_decode import (
    join_streams, lz_decode, read_blocks, stage_batch)
from lizard_tpu_torch.ops.split import (
    STREAMS, TABLE_FIELDS, BlockBatch, finalize, new_accumulator, split_into)
from lizard_tpu_torch.utils import profiling


def build_fused_plan(streams: list[bytes]) -> tuple[BlockBatch, HufPlan]:
    """Split `streams` with a hole for every Huffman-coded stream, and plan
    the Huff0 decode of every blob into its hole. RLE and stored blobs are
    written into their holes here; the batch and plan are on the CPU."""
    return plan_split(lambda acc, hd: split_into(streams, acc, hd))


def plan_split(split) -> tuple[BlockBatch, HufPlan]:
    """build_fused_plan over any split: `split(acc, hd)` fills the
    accumulator `acc` (ops/split.py), passing `hd` for every Huffman-coded
    stream, and returns the batch's codeword family."""
    acc = new_accumulator()
    pend = []                                   # (blob, orig, kind, block)

    def hole(blob, orig, kind):
        pend.append((blob, orig, kind, len(acc["stream_id"])))
        return np.zeros(orig, np.uint8)
    with profiling.span("split", "host"):
        batch = finalize(acc, split(acc, hole))
    with profiling.span("plan", "host"):
        dests, names = [], []
        for _, _, kind, block in pend:
            k = STREAMS.index(kind)
            offsets = getattr(batch, TABLE_FIELDS[2 * k])   # <kind>_off
            dests.append((k, int(offsets[block])))
            names.append(f"stream {int(batch.stream_id[block])}, "
                         f"block {block} ({kind})")
        plan = prepare_huf128([(blob, orig) for blob, orig, _, _ in pend],
                              dests, names)
        for k, off, data in plan.fills:
            getattr(batch, STREAMS[k])[off:off + len(data)] = \
                torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return batch, plan


def decompress_lanes_fused(streams: list[bytes], device=None) -> list[bytes]:
    """decompress_lanes with the entropy stage on `device` (the card unless
    device="cpu"): huf_decode then lz_decode on one stream, and one copy
    back. Raises HufError (a CorruptError) naming the stream and block of
    a corrupt Huff0 segment, CorruptError for a corrupt LZ chain."""
    batch, plan = build_fused_plan(streams)
    return join_streams(batch, decode_fused(batch, plan, device),
                        len(streams))


def decode_fused(batch: BlockBatch, plan: HufPlan, device=None,
                 first: int = 0) -> list[bytes]:
    """The decoded bytes of the blocks from index `first` on of a planned
    batch (plan_split), in batch order: huf_decode (when the plan has
    segments) then lz_decode on one stream of `device`, and one copy back
    (lane_decode.read_blocks)."""
    dev = resolve_device(device)
    args = stage_batch(batch, dev)
    huf_status = None
    if plan.segs.shape[0]:
        huf_status = huf_decode(**plan.stage(dev),
                                **{k: args[k] for k in STREAMS})
    result = lz_decode(**args)
    if huf_status is not None:
        with profiling.span("readback", "device"):
            raise_on_status(huf_status, plan)
    return read_blocks(batch, args, *result, first=first)
