"""Decode over several processes: the port of
lizard_tpu/parallel/multihost.py.

Each process (one a host, or one a card) calls `init_process`, which joins
the torch.distributed group (NCCL where CUDA is present, else gloo); then
`decode_streams_global` splits the streams into world size x local devices
shards, in order, and each rank decodes the shards of its own rank with
ops/decode.py. The one exchange is the all-gather of every shard's
per-block decoded lengths, on the device: from it every process knows each
block's global output offset, and can write its own shard's bytes into a
shared file or buffer without a host exchange (the reference's programs/ do
this with a serial write loop). The codec has no tensor or pipeline
dimension; its one parallel axis is independent frame blocks (SURVEY.md
section 2.5).
"""

import torch
import torch.distributed as dist

from lizard_tpu_torch.ops.split import inner_block_spans
from lizard_tpu_torch.parallel.pipeline import (
    decode_shard, resolve_devices, run_sharded, shard_ids, split_shard)


def init_process(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None) -> bool:
    """Join the torch.distributed group of a multi-process run: backend
    "nccl" when CUDA is present, else "gloo"; `coordinator_address` is an
    init_method URL ("tcp://host:port", "file:///path") or "host:port"
    (then tcp; None: the env:// variables). A no-op returning False for
    one process or none, so one program runs alone or in a group. One call
    a process, before decode_streams_global."""
    if not num_processes or num_processes <= 1:
        return False
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=coordinator_address, world_size=num_processes,
        rank=process_id)
    return True


def global_devices() -> list[torch.device]:
    """This process's share of the global devices: every CUDA device it
    sees (raising when there is none). Every rank contributes as many, and
    the global shards are the ranks' lists one after another (the
    counterpart of global_mesh)."""
    return resolve_devices(None)


def decode_streams_global(streams: list[bytes], max_stream_out: int,
                          devices=None):
    """Decode independent streams over every rank's `devices` (this rank's
    devices, global_devices() for None; every rank passes as many). Returns
    (results, offs): results[i] is stream i's decoded bytes when one of this
    rank's shards holds it, else None; offs is an int64 tensor [shards,
    bmax] on devices[0], the exclusive cumsum, in shard-major order, of
    every shard's per-block decoded lengths (padded with 0 to the most
    blocks of a shard): each block's global output offset. The lengths stay
    on the device: every shard's row of them is put together on devices[0],
    then all-gathered by torch.distributed.all_gather when a group is
    initialised (a world of one too)."""
    devs = resolve_devices(devices)
    grouped = dist.is_available() and dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if grouped
                   else (1, 0))
    local = len(devs)
    n_shards = world * local
    if not streams:
        return [], torch.zeros((n_shards, 0), dtype=torch.int64,
                               device=devs[0])
    ids = shard_ids(len(streams), n_shards)
    bmax = max(max(sum(len(inner_block_spans(streams[i])) for i in g)
                   for g in ids), 1)
    out_cap = max(max(map(len, ids)), 1) * max_stream_out
    mine = ids[rank * local:(rank + 1) * local]
    decoded = run_sharded(
        devs, lambda g, d: decode_shard(split_shard(streams, g), d, out_cap),
        mine)

    results: list = [None] * len(streams)
    lens = torch.zeros((local, bmax), dtype=torch.int64, device=devs[0])
    for k, (g, (pieces, blk_len)) in enumerate(zip(mine, decoded)):
        for i in g:
            results[i] = pieces.get(i, b"")
        lens[k, :blk_len.numel()] = blk_len.to(devs[0])
    if grouped:
        parts = [torch.empty_like(lens) for _ in range(world)]
        dist.all_gather(parts, lens)
        lens = torch.cat(parts)
    flat = lens.reshape(-1)
    return results, (torch.cumsum(flat, 0) - flat).reshape(lens.shape)
