"""Entry points of the all-XLA decode step and the sharded paths: the port
of __graft_entry__.py.

- entry(device): the single-device forward step of the all-XLA decoder
  (ops/decode.py: token parse, expansion, pointer-doubling resolution) on a
  small example batch, as (fn, args).
- dryrun_multichip(n, devices): runs each sharded path once over n shards
  on tiny shapes and checks every round trip: a sharded frame decode, the
  sharded lane decode of both codeword families, decode_streams_global and
  the sharded encode with the far config and the chain config.

As in __graft_entry__.py, the streams and the frame come from the oracle
(ref/block_encode.compress, frame.compress_frame: liblizard's bytes), and
the sharded encoder's blocks are checked with the oracle's decoder
(ref/block_decode.decompress) and with the port's lane decoder.
"""

import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.frame import compress_frame
from lizard_tpu_torch.ops.decode import GUARD, resolve_output, token_parse_lz4
from lizard_tpu_torch.ops.enc_lanes import EncCfg
from lizard_tpu_torch.ops.lane_decode import decompress_lanes
from lizard_tpu_torch.ops.split import finalize, new_accumulator, split_stream
from lizard_tpu_torch.parallel.multihost import decode_streams_global
from lizard_tpu_torch.parallel.pipeline import (
    decode_frame_sharded, decode_streams_sharded_lanes, encode_blocks_sharded,
    resolve_devices)
from lizard_tpu_torch.ref.block_decode import decompress
from lizard_tpu_torch.ref.block_encode import compress
from lizard_tpu_torch.utils.datagen import gen

PROBES = (8, 12, 16, 24, 32, 64, 128, 256)


def _example_batch(n_streams: int = 2, size: int = 3000, level: int = 14):
    acc = new_accumulator()
    family = None
    datas = [gen(size, seed=s) for s in range(n_streams)]
    for i, d in enumerate(datas):
        family = split_stream(compress(d, level), acc, i)
    return finalize(acc, family), sum(map(len, datas))


def entry(device=None):
    """(fn, args): fn(*args) is the all-XLA decode step (token_parse_lz4
    then resolve_output) of a two-stream level-14 batch on `device` (the
    card unless device="cpu"), returning (bytes, per-block lengths)."""
    dev = resolve_device(device)
    batch, total = _example_batch()
    max_steps = batch.max_tokens
    max_tokens_total = int((batch.flags_len + 1).sum())

    def pad(t):
        return torch.cat([t, torch.zeros(GUARD, dtype=torch.uint8)]).to(dev)

    args = (pad(batch.flags), pad(batch.literals), batch.flags_off.to(dev),
            batch.flags_len.to(dev), batch.lit_off.to(dev),
            batch.lit_len.to(dev))

    def fn(flags, lit, flags_off, flags_len, lit_off, lit_len):
        parsed = token_parse_lz4(flags, lit, flags_off, flags_len, lit_off,
                                 lit_len, max_steps)
        return resolve_output(*parsed, flags_len, lit, total,
                              max_tokens_total)

    return fn, args


def _check_encoded(blocks, encs, device, what: str) -> None:
    for d, e in zip(blocks, encs):
        if decompress(e, max_out=max(len(d), 1)) != d:
            raise AssertionError(f"{what}: oracle round trip mismatch")
    if decompress_lanes(encs, device=device) != list(blocks):
        raise AssertionError(f"{what}: lane decode round trip mismatch")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run every sharded path once over n_devices shards on tiny shapes:
    `devices` (every CUDA device for None) must hold n_devices entries, and
    may repeat one (["cuda:0"] * 4, ["cpu"] * 4). Raises on any
    mismatch."""
    devs = resolve_devices(devices)[:n_devices]
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")

    # a multi-block blockIndependent frame over the all-XLA decoder
    data = gen(140_000 * max(2, n_devices) // 2, seed=3)
    if decode_frame_sharded(compress_frame(data, 12), devs) != data:
        raise AssertionError("sharded frame decode mismatch")

    # the lane decoder (lz_decode), both codeword families
    for level in (12, 21):
        datas = [gen(1400 + 23 * i, seed=20 + i, proba=0.6)
                 for i in range(2 * n_devices + 1)]
        got = decode_streams_sharded_lanes(
            [compress(d, level) for d in datas], devs)
        if got != datas:
            raise AssertionError(f"sharded lane decode mismatch (L{level})")

    # the multi-process path, in one process: offsets from the gathered
    # per-block lengths
    datas = [gen(20_000 + 1000 * i, seed=i) for i in range(n_devices + 3)]
    results, offs = decode_streams_global(
        [compress(d, 12) for d in datas], 131072, devs)
    if results != datas or offs.shape[0] != n_devices:
        raise AssertionError("global decode mismatch")

    # the sharded encoder: lazy-2 parse, two h5 tables and the far table;
    # then a chain tier
    cfg_far = EncCfg(n=4096, hl=10, maxoff=2047, lazy=2, k5=2, far=1,
                     far_dist=1024, probes=PROBES)
    far_blocks = [gen(cfg_far.n - 3 * i, seed=60 + i, proba=0.6)
                  for i in range(8 * n_devices)]
    _check_encoded(far_blocks, encode_blocks_sharded(
        far_blocks, level=24, cfg=cfg_far, devices=devs), devs[0],
        "sharded far encode")
    cfg = EncCfg(n=4096, hl=10, maxoff=2047, lazy=1, chain=2, probes=PROBES)
    blocks = [gen(cfg.n - 7 * i, seed=40 + i)
              for i in range(8 * n_devices + 5)]
    _check_encoded(blocks, encode_blocks_sharded(
        blocks, level=17, cfg=cfg, devices=devs), devs[0],
        "sharded chain encode")
