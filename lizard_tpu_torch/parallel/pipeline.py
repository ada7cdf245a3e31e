"""Decode and encode over several devices: the port of
lizard_tpu/parallel/pipeline.py.

The format's one parallel unit is the independent compressed stream (a
frame block in blockIndependent mode, SURVEY.md section 2.5). Streams (or
blocks to compress) are grouped in order over a list of devices, each group
runs the one-device path on its own device, and the results come back in
input order: the only exchange between devices is that ordered gather.

Where the JAX package builds a jax.sharding.Mesh and runs one shard_map step
over it, the port takes `devices`, a list of torch.device (or names), one
shard each. None means every CUDA device and raises when there is none
(device.py's rule). A device may repeat: ["cuda:0"] * 4 is four shards on
one card, ["cpu"] * 4 four shards on the CPU (the plain versions, as the
tests run). Shards on distinct devices run at once, one host thread a
device inside torch.cuda.device(d); shards that share a device run one
after another in its thread. Each shard is its own launch, so nothing has to
match across shards: no common geometry, family or chain depth.
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.format.constants import LIZARDF_BLOCK_SIZES
from lizard_tpu_torch.format.levels import Codewords
from lizard_tpu_torch.frame import (
    FrameError, _frame_blocks, frame_end, parse_frame_header, whole_frame)
from lizard_tpu_torch.ops.decode import decode_batch
from lizard_tpu_torch.ops.enc_lanes import cfg_for_level, encode_blocks_lanes
from lizard_tpu_torch.ops.lane_decode import decompress_lanes
from lizard_tpu_torch.ops.split import finalize, new_accumulator, split_stream


def resolve_devices(devices=None) -> list[torch.device]:
    """The shards' devices: every CUDA device for None (raising when there
    is none), else `devices` as torch.device; "cuda" names the current
    card."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def run_sharded(devices: list[torch.device], fn, shards: list) -> list:
    """[fn(shard, device) for each shard and its device], in order. The
    shards of one device run one after another; distinct devices run at
    once, one thread each, inside torch.cuda.device(d) so that the
    kernels' wrappers launch on d's current stream."""
    by_device = {}
    for k, d in enumerate(devices):
        by_device.setdefault(d, []).append(k)
    results = [None] * len(shards)

    def work(d, ks):
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            for k in ks:
                results[k] = fn(shards[k], d)

    if len(by_device) == 1:
        work(*next(iter(by_device.items())))
        return results
    with ThreadPoolExecutor(len(by_device)) as pool:
        for f in [pool.submit(work, d, ks) for d, ks in by_device.items()]:
            f.result()
    return results


def _group(n_items: int, n_shards: int):
    """Contiguous balanced grouping preserving order."""
    return [i * n_shards // max(n_items, 1) for i in range(n_items)]


def _contiguous(items: list, n_shards: int) -> list[list]:
    """`items` cut in order into n_shards runs of near-equal length."""
    bounds = [len(items) * k // n_shards for k in range(n_shards + 1)]
    return [items[bounds[k]:bounds[k + 1]] for k in range(n_shards)]


def split_shard(streams: list[bytes], ids: list[int]):
    """One shard's BlockBatch: streams[i] for i in `ids`, stream i keeping
    id i (its family is its last stream's, LIZv1 when empty, as in the JAX
    function)."""
    acc = new_accumulator()
    family = None
    for i in ids:
        family = split_stream(streams[i], acc, i)
    return finalize(acc, family or Codewords.LIZv1)


def decode_shard(batch, device, out_cap: int):
    """ops/decode.py's decode_batch of one shard on `device`: ({stream id:
    its decoded bytes}, the per-block lengths, an int64 tensor on the
    device)."""
    out, blk_len = decode_batch(batch, out_cap, device)
    lens = blk_len.cpu().tolist()
    data = out[:sum(lens)].cpu().numpy()
    pieces, pos = {}, 0
    for sid, n in zip(batch.stream_id.tolist(), lens):
        pieces.setdefault(sid, []).append(data[pos:pos + n].tobytes())
        pos += n
    return {sid: b"".join(p) for sid, p in pieces.items()}, blk_len


def shard_ids(n_streams: int, n_shards: int) -> list[list[int]]:
    """The stream indices of each shard, by _group."""
    ids = [[] for _ in range(n_shards)]
    for i, s in enumerate(_group(n_streams, n_shards)):
        ids[s].append(i)
    return ids


def decode_streams_sharded(streams: list[bytes], max_stream_out: int,
                           devices=None) -> list[bytes]:
    """Decode independent compressed streams over `devices` with the
    all-XLA decoder (ops/decode.py), one shard each. Returns the decoded
    bytes per stream, in input order. `max_stream_out` bounds any single
    stream's decoded size (frame maxBlockSize); every shard's output holds
    that many bytes for each stream of the fullest shard, as in the JAX
    function (a stream decoding to more is cut there)."""
    devs = resolve_devices(devices)
    if not streams:
        return []
    ids = shard_ids(len(streams), len(devs))
    out_cap = max(max(map(len, ids)), 1) * max_stream_out
    batches = [split_shard(streams, g) for g in ids]
    results: list[bytes] = [b""] * len(streams)
    for pieces, _ in run_sharded(
            devs, lambda b, d: decode_shard(b, d, out_cap), batches):
        for sid, data in pieces.items():
            results[sid] = data
    return results


def decode_frame_sharded(frame: bytes, devices=None) -> bytes:
    """Decode a blockIndependent frame with its compressed blocks spread
    over `devices` (decode_streams_sharded); stored blocks are spliced in
    on the host, in frame order. Raises FrameError as the JAX function does,
    and, with the messages of frame.decompress_frame, for a truncated block,
    a missing checksum, a wrong content size and bytes after the frame
    (a second frame included), which the JAX function does not check."""
    info = parse_frame_header(frame)
    if info.block_linked:
        raise FrameError("sharded decode requires independent blocks")
    units, p = _frame_blocks(frame, info.header_size)
    decoded = iter(decode_streams_sharded(
        [blob for stored, blob in units if not stored],
        LIZARDF_BLOCK_SIZES[info.block_size_id], devices))
    out = bytearray()
    for stored, blob in units:
        out += blob if stored else next(decoded)
    out = bytes(out)
    whole_frame(frame, frame_end(frame, p, info, out))
    return out


def decode_streams_sharded_lanes(streams: list[bytes],
                                 devices=None) -> list[bytes]:
    """Decode independent compressed streams with the port's production
    decoder, ops/lane_decode.py::decompress_lanes (lz_decode, after
    huf_decode at levels 30-49), over `devices`: streams cut in order into
    one contiguous run a device, one call a shard. Returns the decoded
    bytes per stream.

    The Huff0 streams are decoded on the device; the JAX function's
    default decodes them on the host, and it refuses shards of two
    codeword families or of unequal chain depths, which its one TPU kernel
    instance over all shards cannot mix; here each shard is its own launch
    and such input decodes. Its TPU geometry knobs (spb, rtiles, groups,
    il) have no counterpart."""
    devs = resolve_devices(devices)
    outs = run_sharded(
        devs, lambda part, d: (decompress_lanes(part, device=d)
                               if part else []),
        _contiguous(streams, len(devs)))
    return [b for o in outs for b in o]


def encode_blocks_sharded(blocks, level: int = 10, cfg=None, devices=None,
                          entropy: str = "gpu") -> list[bytes]:
    """Compress blocks of up to cfg.n bytes over `devices`: the blocks cut
    in order into one contiguous run a device, each run compressed by
    ops/enc_lanes.py::encode_blocks_lanes on its device (match_find,
    chain_walk at x6-x9, parse_tokens; native emission; huf_pack at 30-49
    on entropy="gpu"). Byte-equal to encode_blocks_lanes on one device: one
    container stream (level byte + inner block) per block. An error in any
    shard propagates; there is no host re-encode (the JAX function's
    fallback serves a token cap that the port does not have)."""
    devs = resolve_devices(devices)
    if cfg is None:
        cfg = cfg_for_level(level)
    outs = run_sharded(
        devs, lambda part, d: (encode_blocks_lanes(part, level, cfg, d,
                                                   entropy)
                               if part else []),
        _contiguous(list(blocks), len(devs)))
    return [b for o in outs for b in o]
