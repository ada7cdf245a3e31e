"""The device encoder: the port of lizard_tpu/ops/enc_lanes.py (its host
pipeline and its three Pallas kernels `_p1_kernel`, `_p15_kernel` and
`_pA_kernel`, here the CUDA kernels csrc/enc_match.cu, csrc/enc_chain.cu and
csrc/enc_parse.cu).

Blocks of up to cfg.n bytes (128 KB at every level) are compressed in three
device steps, then emission, the entropy stage and the containers:

1. `match_find` (B5): per position, the hash-table lookups with their 4-byte
   verify, the probe ladder, the far table (LIZv1 families) and the delta map
   (chain tiers), with the tables updated segment by segment (128 positions);
2. `chain_walk` (B6, levels x6-x9): per position, the hash-chain walk over
   the delta map, its winner into map 0;
3. `parse_tokens` (B7): per block, the serial greedy/lazy parse over the
   candidate maps into (start, length, offset) tokens;
4. emission of the level's codewords by the native emitters (host);
5. at levels 30-49 the Huff0 stage of every block's flags and literals
   streams: on the card in one `huf_pack` call for the whole batch
   (entropy="gpu", ops/enc_huf.py, kernel B8) or by the native Huff0 on the
   host (entropy="host"); then each block's container.

The contract of each device step is the JAX package's numpy mirror of its
Pallas kernel (p1_reference, p15_reference, p2_reference): the port is
token-exact with the JAX package. None of the TPU layout is kept: no (8, 128)
word tiling, no d16 packing of the maps, no token slots, no token cap and so
no TokenOverflow and no host fallback.

Each device step has a wrapper (`match_find`, `chain_walk`, `parse_tokens`)
and a plain PyTorch version with the same signature and outputs
(`*_plain`). A CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. Their calls are counted in utils/profiling.py as
"match_find.launches", "chain_walk.launches" and "parse_tokens.launches".
"""

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lizard_tpu_torch import runtime
from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.format.constants import (
    FLAG_FLAGS,
    FLAG_LITERALS,
    FLAG_OFFSET16,
    FLAG_OFFSET24,
    FLAG_UNCOMPRESSED,
    HUF_MIN_STREAM_LEN,
    LASTLITERALS,
    LIZARD_BLOCK_SIZE,
    LIZARD_MIN_LENGTH,
    MFLIMIT,
    MM_LONGOFF,
    minimal_block_gain,
    minimal_huff_gain,
)
from lizard_tpu_torch.ops import _build
from lizard_tpu_torch.ops.enc_huf import huf_compress_batch
from lizard_tpu_torch.utils import profiling

SEG = 128                     # positions per segment (one table update)
HMUL = 2654435761
H5MIX = 0x9E3B                # 5th-byte mix constant of the h5 hash
PAD = 8                       # zero bytes past n in a packed row (w8, h5)
_CHK1 = 0x85EBCA6B            # chk13 mixing constants, as uint32: the JAX
_CHK2 = 0xC2B2AE3D            # package's int32 values (its comment names
_CHK3 = 668265263             # xxhash's 0xC2B2AE35, its value is ...3D)
_M32 = 0xFFFFFFFF
MAX_PROBES = 16               # probe-ladder slots of the kernels' config
GROUP = 1024                  # blocks per device batch of encode_blocks_lanes


@dataclass(frozen=True)
class EncCfg:
    """Encoder geometry and tier (lizard_tpu/ops/enc_lanes.py::EncCfg,
    without the TPU's token-buffer size `tok_rows`)."""
    n: int = 131072           # padded block size (bytes)
    hl: int = 13              # hash/table bits
    maxoff: int = 16383       # max match offset emitted
    min_offset: int = 8       # LIZARD_FAST_MIN_OFFSET (interop: >= 8)
    probes: tuple = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                     384, 512, 768, 1024)
    lazy: int = 0             # lazy look-ahead steps of the parse (0-2)
    k5: int = 0               # 5-byte-hash tables: 0 none; 1 one table whose
                              # verified candidate overrides map 0; 2 or 4
                              # rotating-slot tables, each its own map
    chain: int = 0            # hash-chain walk depth (chain_walk); adds the
                              # delta map to match_find's output
    pref: int = 8             # chain ranking depth in bytes (8 or 16)
    far_dist: int = 65536     # far-table delay in bytes (multiple of 512)
    far: int = 0              # off24 candidates (LIZv1 families): one more
                              # table, inserts delayed by far_dist; its map
                              # holds raw = distance - (far_dist - 1)

    @property
    def nmaps(self):
        """Maps out of match_find: h4+probes, the k5 slots, far, delta."""
        if self.far and self.chain:
            raise ValueError("far and chain together are not supported")
        base = 1 if self.k5 <= 1 else 1 + self.k5
        return base + (1 if self.far else 0) + (1 if self.chain else 0)

    @property
    def ncand(self):
        """Maps the parse reads: chain_walk drops the delta map."""
        return self.nmaps - (1 if self.chain else 0)

    @property
    def nseg(self):
        return self.n // SEG

    @property
    def ntab(self):
        """Hash tables of match_find: h4, the k5 slots, far."""
        return 1 + self.k5 + (1 if self.far else 0)

    @property
    def max_tokens(self):
        """Token slots per block: every token advances the cursor by at
        least MINMATCH bytes."""
        return self.n // 4 + 1


def cfg_for_level(level: int) -> EncCfg:
    """Level-mapped encoder geometry (lizard_tpu/ops/enc_lanes.py::
    cfg_for_level): x0 greedy, x1 lazy, x2 lazy + one h5 table, x3-x4 two
    h5 slots and lazy 2, x5 four slots, x6-x9 the hash-chain tiers. The
    LIZv1 families (20-29, 40-49) add the far table at x0-x5."""
    sub = level % 10
    far = 1 if (level // 10) in (2, 4) and sub <= 5 else 0
    if sub == 0:
        return EncCfg(maxoff=65535, far=far)
    if sub == 1:
        return EncCfg(maxoff=65535, lazy=1, far=far)
    if sub == 2:
        return EncCfg(maxoff=65535, lazy=1, k5=1, far=far)
    if sub <= 4:
        return EncCfg(maxoff=65535, lazy=2, k5=2, far=far)
    if sub == 5:
        return EncCfg(maxoff=65535, lazy=2, k5=4, far=far)
    if sub == 6:
        return EncCfg(maxoff=65535, lazy=2, chain=16, hl=15)
    if sub == 7:
        return EncCfg(maxoff=65535, lazy=2, chain=16, hl=15, pref=16)
    if sub == 8:
        return EncCfg(maxoff=65535, lazy=2, chain=32, hl=16, pref=16)
    return EncCfg(maxoff=65535, lazy=2, chain=64, hl=16, pref=16)


# ---------------------------------------------------------------- host util

def pack_blocks(blocks, cfg: EncCfg, device="cpu"):
    """blocks: byte strings of at most cfg.n bytes each. Returns (data,
    lens): data a (B, n + 8) uint8 tensor, each row a block zero-padded
    (the hashes read up to 4 bytes past a position, and past n the bytes are
    zero), lens (B,) int32; both on `device`."""
    u8 = np.zeros((len(blocks), cfg.n + PAD), np.uint8)
    lens = np.zeros(len(blocks), np.int32)
    for b, d in enumerate(blocks):
        if len(d) > cfg.n:
            raise ValueError(f"block {b}: {len(d)} bytes > cfg.n = {cfg.n}")
        u8[b, :len(d)] = np.frombuffer(d, np.uint8)
        lens[b] = len(d)
    host = torch.from_numpy(u8), torch.from_numpy(lens)
    with profiling.span("pack", "device"):
        staged = tuple(t.to(device) for t in host)
    profiling.count_bytes("h2d_bytes", *host)
    return staged


def maps_from_reference(ref, cfg: EncCfg = None) -> torch.Tensor:
    """The JAX mirrors' int64 maps (p1_reference/p15_reference output, shape
    (B, n) for one map or (B, maps, n)) as the port's (B, maps, n) uint16
    tensor."""
    a = np.asarray(ref)
    if a.ndim == 2:
        a = a[:, None, :]
    if a.min(initial=0) < 0 or a.max(initial=0) > 0xFFFF:
        raise ValueError("map values must lie in [0, 65535]")
    if cfg is not None and a.shape[2] != cfg.n:
        raise ValueError(f"maps have {a.shape[2]} positions, cfg.n {cfg.n}")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.uint16)))


def _check_data(data, lens, cfg: EncCfg):
    if (data.dtype != torch.uint8 or data.dim() != 2
            or data.shape[1] != cfg.n + PAD or not data.is_contiguous()):
        raise ValueError(f"data must be a contiguous (B, {cfg.n + PAD}) "
                         "uint8 tensor")
    if (lens.dtype != torch.int32 or lens.dim() != 1
            or lens.shape[0] != data.shape[0] or not lens.is_contiguous()):
        raise ValueError("lens must be a contiguous (B,) int32 tensor")
    if lens.device != data.device:
        raise ValueError(f"lens is on {lens.device}, data on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu, not {data.device}")


def _check_maps(maps, data, m: int, cfg: EncCfg):
    shape = (data.shape[0], m, cfg.n)
    if (maps.dtype != torch.uint16 or tuple(maps.shape) != shape
            or not maps.is_contiguous()):
        raise ValueError(f"maps must be a contiguous {shape} uint16 tensor")
    if maps.device != data.device:
        raise ValueError(f"maps is on {maps.device}, data on {data.device}")


def _stream_args(t: torch.Tensor):
    return t.data_ptr(), torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ------------------------------------------------------ B5: match_find

def _match_params(cfg: EncCfg):
    if len(cfg.probes) > MAX_PROBES:
        raise ValueError(f"at most {MAX_PROBES} probes")
    if cfg.k5 not in (0, 1, 2, 4):
        raise ValueError("k5 must be 0, 1, 2 or 4")
    if cfg.n % SEG or cfg.far_dist % SEG or not 8 <= cfg.hl <= 16:
        raise ValueError("n and far_dist must be multiples of 128, "
                         "8 <= hl <= 16")
    if cfg.maxoff > 0xFFFF or not all(0 < d <= 0xFFFF for d in cfg.probes):
        raise ValueError("maxoff and the probes must fit the uint16 maps, "
                         "probes > 0")
    vals = [cfg.n, cfg.n + PAD, cfg.hl, cfg.maxoff, cfg.min_offset,
            cfg.k5, cfg.far, cfg.far_dist, cfg.chain, cfg.nmaps,
            len(cfg.probes)]
    vals += list(cfg.probes) + [0] * (MAX_PROBES - len(cfg.probes))
    return (ctypes.c_int32 * len(vals))(*vals)


def match_find(data, lens, cfg: EncCfg) -> torch.Tensor:
    """Candidate maps of every position of every packed block: (B, nmaps, n)
    uint16, 0 = none, else the match distance (far map: distance -
    (far_dist - 1); delta map: distance to the previous occupant of the
    position's h4 bucket, unverified). Counterpart of p1_call/_p1_kernel
    and of the mirror p1_reference.

    CUDA tensors launch csrc/enc_match.cu on the current stream without
    synchronising; CPU tensors run match_find_plain."""
    _check_data(data, lens, cfg)
    with profiling.span("match_find", "device"):
        if data.device.type == "cpu":
            return match_find_plain(data, lens, cfg)
        return _match_launch(data, lens, cfg, None)


def match_find_profile(data, lens, cfg: EncCfg):
    """match_find on CUDA tensors, with a per-block profile beside the maps:
    (maps, prof int64 (B, 7)), prof's columns the block's clock cycles, the
    table loop's busy cycles (its lookups, barriers and inserts), a worker
    warp's busy cycles in key work and in verify work (means over the
    worker warps), the table loop's busy ns on the card's global timer, the
    positions that walked the probe ladder, and the block's ns. It launches
    the kernel's profiling instance (the plain call reads no clock). Counts
    as one match_find call."""
    _check_data(data, lens, cfg)
    if data.device.type != "cuda":
        raise ValueError(f"match_find_profile runs on cuda, not "
                         f"{data.device}")
    prof = torch.zeros((data.shape[0], 7), dtype=torch.int64,
                       device=data.device)
    return _match_launch(data, lens, cfg, prof), prof


def _match_launch(data, lens, cfg: EncCfg, prof):
    """One launch of csrc/enc_match.cu on CUDA tensors; `prof` (int64
    (B, 7), or None) receives the per-block profile. The tables' global
    scratch, where the kernel keeps them there (hl 16), is a torch.empty
    tensor of the size the kernel asks for."""
    params = _match_params(cfg)
    if data.data_ptr() % 8:
        raise ValueError("match_find on the card reads rows as aligned "
                         "words: pass an 8-byte aligned data tensor")
    B = data.shape[0]
    maps = torch.empty((B, cfg.nmaps, cfg.n), dtype=torch.uint16,
                       device=data.device)
    if B == 0:
        return maps
    lib = _build.load("enc_match")
    size = lib.match_find_table_bytes
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_void_p]
    table_bytes = size(ctypes.cast(params, ctypes.c_void_p))
    tables = (torch.empty(B * table_bytes // 4, dtype=torch.int32,
                          device=data.device) if table_bytes else None)
    fn = lib.match_find_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(data.device):
        ptr, stream = _stream_args(data)
        err = fn(ptr, lens.data_ptr(), B,
                 ctypes.cast(params, ctypes.c_void_p), maps.data_ptr(),
                 None if tables is None else tables.data_ptr(),
                 None if prof is None else prof.data_ptr(), stream)
    _raise_on(err, "match_find")
    profiling.count("match_find.launches")
    return maps


def _words(data):
    """(B, n + 4) int64: the 4 little-endian bytes at each position."""
    d = data.to(torch.int64)
    w = d.shape[1] - 3
    return d[:, :w] | d[:, 1:w + 1] << 8 | d[:, 2:w + 2] << 16 \
        | d[:, 3:w + 3] << 24


def _hash(w, hl):
    return ((w * HMUL) & _M32) >> (32 - hl)


def _chk13(w, cfg: EncCfg):
    """13-bit checksum of each position's first 16 bytes, from the words at
    +0/+4/+8/+12 taken circularly within the position's 128-byte segment
    (the TPU kernel's lane rolls; part of the contract: lanes above 115 mix
    words from the segment's start)."""
    W = w[:, :cfg.n].reshape(w.shape[0], cfg.nseg, SEG)
    mix = (W ^ ((torch.roll(W, -4, 2) * _CHK1) & _M32)
           ^ ((torch.roll(W, -8, 2) * _CHK2) & _M32)
           ^ ((torch.roll(W, -12, 2) * _CHK3) & _M32))
    return ((((mix * HMUL) & _M32) >> 19) & 8191).reshape(w.shape[0], cfg.n)


def _insert(tab, cnt, hs, vals, valid, trash):
    """One segment's insert into one table (B, 2^hl + 1): a lane is kept if
    it is the last lane or its bucket differs from the next lane's, and it
    is valid; a bucket hit by exactly one kept lane takes that lane's value,
    a bucket hit by two or more keeps its old entry. Column `trash` absorbs
    the lanes that write nothing."""
    keep = valid.clone()
    keep[:, :-1] &= hs[:, :-1] != hs[:, 1:]
    hk = torch.where(keep, hs, trash)
    cnt.scatter_add_(1, hk, torch.ones_like(hk))
    one = keep & (cnt.gather(1, hk) == 1)
    cnt.scatter_(1, hk, 0)
    tab.scatter_(1, torch.where(one, hs, trash), vals)


def match_find_plain(data, lens, cfg: EncCfg) -> torch.Tensor:
    """The plain PyTorch version of match_find, the same function as the
    mirror p1_reference: vectorised over blocks and the 128 positions of a
    segment, a Python loop over segments. The unique-bucket rule of the
    insert counts lanes per bucket with scatter_add."""
    _check_data(data, lens, cfg)
    dev, B, n = data.device, data.shape[0], cfg.n
    maps = torch.zeros((B, cfg.nmaps, n), dtype=torch.uint16, device=dev)
    if B == 0:
        return maps
    tsize = 1 << cfg.hl
    w = _words(data)                              # positions 0 .. n+3
    wn = w[:, :n]
    h = _hash(wn, cfg.hl)
    if cfg.k5:
        b4 = data[:, 4:n + 4].to(torch.int64)     # the byte at p + 4
        h5 = _hash(wn ^ (b4 * H5MIX), cfg.hl)
    if cfg.far:
        chk = _chk13(w, cfg)
    lens64 = lens.to(torch.int64)[:, None]
    emit_ok = lens64 >= LIZARD_MIN_LENGTH
    tabs = torch.zeros((cfg.ntab, B, tsize + 1), dtype=torch.int64,
                       device=dev)
    cnt = torch.zeros((B, tsize + 1), dtype=torch.int64, device=dev)
    lane = torch.arange(SEG, device=dev)
    probes = torch.tensor(cfg.probes, dtype=torch.int64, device=dev)
    far_seg = cfg.far_dist // SEG
    FD = cfg.far_dist
    for i in range(cfg.nseg):
        ps = i * SEG + lane
        sl = slice(i * SEG, (i + 1) * SEG)
        wseg, hs = wn[:, sl], h[:, sl]
        ok_emit = emit_ok & (ps < lens64 - MFLIMIT)

        def lookup(t, hh):
            v = tabs[t].gather(1, hh)
            c0 = v - 1
            off = ps - c0
            ok = ((v > 0) & (wn.gather(1, c0.clamp(0, n - 1)) == wseg)
                  & (off >= cfg.min_offset) & (off <= cfg.maxoff))
            return v, ok, c0

        v4, ok4, c4 = lookup(0, hs)
        best = torch.where(ok4, c4, -1)
        if len(cfg.probes):
            c = ps[None, :] - probes[:, None]                 # (probes, 128)
            hit = (c >= 0) & (wn[:, c.clamp(min=0)] == wseg[:, None, :])
            first = torch.where(hit, torch.arange(len(cfg.probes),
                                                  device=dev)[:, None],
                                len(cfg.probes)).min(1).values
            cp = ps - probes[first.clamp(max=len(cfg.probes) - 1)]
            best = torch.where((best < 0) & (first < len(cfg.probes)), cp,
                               best)
        bests = [best]
        if cfg.k5:
            h5s = h5[:, sl]
            slots = [lookup(1 + j, h5s) for j in range(cfg.k5)]
            if cfg.k5 == 1:
                bests = [torch.where(slots[0][1], slots[0][2], best)]
            else:
                bests += [torch.where(ok, c0, -1) for _, ok, c0 in slots]
        for m, bm in enumerate(bests):
            maps[:, m, sl] = torch.where(ok_emit & (bm >= 0), ps - bm,
                                         0).to(torch.uint16)
        if cfg.far:
            vF = tabs[cfg.ntab - 1].gather(1, hs)
            offF = ps - ((vF >> 13) - 1)
            okF = ((vF > 0) & ((vF & 8191) == chk[:, sl]) & (offF >= FD)
                   & (offF <= 2 * FD - 2))
            maps[:, len(bests), sl] = torch.where(
                ok_emit & okF, offF - (FD - 1), 0).to(torch.uint16)
        if cfg.chain:
            dl = ps - (v4 - 1)
            maps[:, cfg.nmaps - 1, sl] = torch.where(
                (v4 > 0) & (dl < (1 << 16)), dl, 0).to(torch.uint16)
        valid = ps < lens64
        _insert(tabs[0], cnt, hs, (ps + 1).expand(B, SEG), valid, tsize)
        if cfg.k5:
            _insert(tabs[1 + (i & (cfg.k5 - 1))], cnt, h5s,
                    (ps + 1).expand(B, SEG), valid, tsize)
        if cfg.far and i >= far_seg:
            sj = slice((i - far_seg) * SEG, (i - far_seg + 1) * SEG)
            qs = ps - FD
            _insert(tabs[cfg.ntab - 1], cnt, h[:, sj],
                    ((qs + 1) << 13) | chk[:, sj], qs < lens64, tsize)
    return maps


# ------------------------------------------------------ B6: chain_walk

def chain_walk(data, lens, maps, cfg: EncCfg) -> torch.Tensor:
    """The hash-chain walk (levels x6-x9) over match_find's maps: per
    position, from the map-0 candidate, walk cur += delta[p - cur] for
    cfg.chain steps (stopping at the first step with no delta or past
    maxoff), rank every node by its matched prefix capped at cfg.pref bytes
    (a node needs >= 4 and must be strictly longer, so the nearest keeps
    ties; the first candidate is ranked without the gate), and return the
    parse's (B, ncand, n) maps: map 0 the winner, the delta map dropped,
    the others passed through. Counterpart of p15_call/_p15_kernel and of
    the mirror p15_reference.

    The output is a new tensor. CUDA tensors launch csrc/enc_chain.cu on the
    current stream without synchronising; CPU tensors run chain_walk_plain."""
    _check_data(data, lens, cfg)
    _check_maps(maps, data, cfg.nmaps, cfg)
    if not cfg.chain:
        raise ValueError("chain_walk needs cfg.chain > 0")
    with profiling.span("chain_walk", "device"):
        if data.device.type == "cpu":
            return chain_walk_plain(data, lens, maps, cfg)
        return _chain_launch(data, maps, cfg, None)


def chain_walk_profile(data, lens, maps, cfg: EncCfg):
    """chain_walk on CUDA tensors, with a profile beside the output: (out,
    prof int64 (CTAs, 6)), one row per CTA (a slice of 8192 positions of a
    block, the slices of block b in rows b * slices ...), its columns the
    lane slots of the walk loop (32 an iteration of a warp), the clock
    cycles of the nodes' delta reads and of their ranking (each timed
    alone), the nodes walked, the positions walked (a candidate in map 0),
    and the CTA's ns on the card's global timer. It launches the kernel's
    profiling instance (the plain call reads no clock). Counts as one
    chain_walk call."""
    _check_data(data, lens, cfg)
    _check_maps(maps, data, cfg.nmaps, cfg)
    if data.device.type != "cuda" or not cfg.chain:
        raise ValueError("chain_walk_profile runs on cuda with cfg.chain > 0")
    ctas = _build.load("enc_chain").chain_walk_ctas(data.shape[0], cfg.n)
    prof = torch.zeros((ctas, 6), dtype=torch.int64, device=data.device)
    return _chain_launch(data, maps, cfg, prof), prof


def _chain_launch(data, maps, cfg: EncCfg, prof):
    """One launch of csrc/enc_chain.cu on CUDA tensors (one CTA a slice of
    8192 positions, its 64 KB window in shared memory); `prof` (int64, one
    row per CTA, or None) receives the profile."""
    if cfg.n % SEG or cfg.pref > 16 or cfg.maxoff > 0xFFFF:
        raise ValueError(f"chain_walk on the card takes blocks of a multiple "
                         f"of {SEG} bytes, pref <= 16 and maxoff <= 65535, "
                         f"not {cfg.n}, {cfg.pref} and {cfg.maxoff}")
    if data.data_ptr() % 8 or maps.data_ptr() % 16:
        raise ValueError("chain_walk on the card reads rows as 8-byte and "
                         "maps as 16-byte words: pass tensors so aligned")
    B = data.shape[0]
    out = torch.empty((B, cfg.ncand, cfg.n), dtype=torch.uint16,
                      device=data.device)
    if B == 0:
        return out
    fn = _build.load("enc_chain").chain_walk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 3)
    with torch.cuda.device(data.device):
        ptr, stream = _stream_args(data)
        err = fn(ptr, maps.data_ptr(), B, cfg.n, cfg.n + PAD, cfg.nmaps,
                 cfg.ncand, cfg.chain, cfg.pref, cfg.maxoff,
                 out.data_ptr(), None if prof is None else prof.data_ptr(),
                 stream)
    _raise_on(err, "chain_walk")
    profiling.count("chain_walk.launches")
    return out


def chain_walk_plain(data, lens, maps, cfg: EncCfg) -> torch.Tensor:
    """The plain PyTorch version of chain_walk, the mirror p15_reference:
    vectorised over every position of every block, a loop over the chain
    steps and, within a step, over the pref bytes. Bytes past the row read
    as zero."""
    _check_data(data, lens, cfg)
    _check_maps(maps, data, cfg.nmaps, cfg)
    dev, B, n = data.device, data.shape[0], cfg.n
    out = torch.zeros((B, cfg.ncand, n), dtype=torch.uint16, device=dev)
    if B == 0:
        return out
    u8 = torch.zeros((B, n + PAD + cfg.pref), dtype=torch.int64, device=dev)
    u8[:, :n + PAD] = data
    pos = torch.arange(n, device=dev)[None, :]
    cand = maps[:, 0].to(torch.int64)
    delta = maps[:, cfg.nmaps - 1].to(torch.int64)

    def plen(dist):
        ok = dist > 0
        src = (pos - dist).clamp(min=0)
        m = ok.clone()
        ln = torch.zeros_like(dist)
        for j in range(cfg.pref):
            m &= u8.gather(1, src + j) == u8[:, j:j + n]
            ln += m
        return torch.where(ok, ln, 0)

    best_d = cand.clone()
    best_l = plen(best_d)
    cur = best_d.clone()
    walking = cand > 0
    for _ in range(cfg.chain):
        if not bool(walking.any()):
            break
        nd = torch.where(walking, delta.gather(1, (pos - cur).clamp(min=0)),
                         0)
        cur2 = cur + nd
        valid = walking & (nd > 0) & (cur2 <= cfg.maxoff)
        ln = plen(torch.where(valid, cur2, 0))
        take = valid & (ln >= 4) & (ln > best_l)
        best_d = torch.where(take, cur2, best_d)
        best_l = torch.where(take, ln, best_l)
        cur = torch.where(valid, cur2, cur)
        walking = valid
    out[:, 0] = best_d.to(torch.uint16)
    out[:, 1:] = maps[:, 1:cfg.ncand]
    return out


# ------------------------------------------------------ B7: parse_tokens

def _parse_cfg(cfg: EncCfg) -> EncCfg:
    """The parse reads ncand maps and never walks a chain."""
    return dataclasses.replace(cfg, chain=0) if cfg.chain else cfg


def parse_tokens(data, lens, maps, cfg: EncCfg):
    """The serial greedy/lazy parse of every block over its (B, ncand, n)
    candidate maps (after chain_walk at the chain tiers). Returns (tok,
    counts): tok (B, n/4 + 1, 3) int32 rows (start, length, offset) in parse
    order, counts (B,) int32 tokens per block (-1 if the slots overflowed,
    which valid maps cannot cause: every token advances the cursor by at
    least 4). Counterpart of pA_call/_pA_kernel and of the mirror
    p2_reference.

    CUDA tensors launch csrc/enc_parse.cu (one CTA of 16 warps a block,
    cfg.n a multiple of 128 up to 128 KB) on the current stream without
    synchronising; CPU tensors run parse_tokens_plain."""
    _check_data(data, lens, cfg)
    _check_maps(maps, data, cfg.ncand, cfg)
    with profiling.span("parse_tokens", "device"):
        if data.device.type == "cpu":
            return parse_tokens_plain(data, lens, maps, cfg)
        return _parse_launch(data, lens, maps, cfg, None)


def parse_tokens_profile(data, lens, maps, cfg: EncCfg):
    """parse_tokens on CUDA tensors, with a per-block profile beside the
    outputs: (tok, counts, prof int64 (B, 5)), prof's columns the block's
    clock cycles, the cycles its walker warp and its first picking warp
    were busy, the walker's steps (candidate positions visited) and the
    walker's busy time in ns on the card's global timer; zeros for a block
    under 21 bytes. It launches the kernel's profiling instance (the plain
    call reads no clock). Counts as one parse_tokens call."""
    _check_data(data, lens, cfg)
    _check_maps(maps, data, cfg.ncand, cfg)
    if data.device.type != "cuda":
        raise ValueError(f"parse_tokens_profile runs on cuda, not "
                         f"{data.device}")
    prof = torch.zeros((data.shape[0], 5), dtype=torch.int64,
                       device=data.device)
    return (*_parse_launch(data, lens, maps, cfg, prof), prof)


def _parse_launch(data, lens, maps, cfg: EncCfg, prof):
    """One launch of csrc/enc_parse.cu on CUDA tensors; `prof` (int64
    (B, 5), or None) receives the per-block profile."""
    if cfg.n % SEG or cfg.n > LIZARD_BLOCK_SIZE or cfg.ncand > 6 \
            or cfg.lazy > 2:
        raise ValueError(f"parse_tokens on the card takes blocks of a "
                         f"multiple of {SEG} bytes up to 128 KB (its shared "
                         f"memory), at most 6 maps and 2 lazy steps, not "
                         f"{cfg.n}, {cfg.ncand} and {cfg.lazy}")
    if data.data_ptr() % 8 or maps.data_ptr() % 16:
        raise ValueError("parse_tokens on the card reads rows as 8-byte and "
                         "maps as 16-byte words: pass tensors so aligned")
    B, T = data.shape[0], cfg.max_tokens
    # slot T is the kernel's spare: a step without a token stores there
    tok = torch.empty((B, T + 1, 3), dtype=torch.int32, device=data.device)
    counts = torch.empty(B, dtype=torch.int32, device=data.device)
    if B == 0:
        return tok[:, :T], counts
    fn = _build.load("enc_parse").parse_tokens_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4)
    with torch.cuda.device(data.device):
        ptr, stream = _stream_args(data)
        err = fn(ptr, lens.data_ptr(), maps.data_ptr(), B, cfg.n,
                 cfg.n + PAD, cfg.ncand, cfg.lazy, cfg.far, cfg.far_dist, T,
                 tok.data_ptr(), counts.data_ptr(),
                 None if prof is None else prof.data_ptr(), stream)
    _raise_on(err, "parse_tokens")
    profiling.count("parse_tokens.launches")
    return tok[:, :T], counts


def _first_mismatch(u8, flat, start, dist, lim, win):
    """(offset of the first mismatching byte in [start, start + win), win
    if none) of each evaluation: bytes y < lim + 3 against y - dist. The
    evaluations' bytes are gathered from the (B, W) rows `u8` (evaluations
    shaped (B, K), row b for b) or, with `flat` the flat byte indices of
    each evaluation's row start, from u8 flattened."""
    k = torch.arange(win, device=u8.device)
    y = start[..., None] + k
    W = u8.shape[1]
    a, b = y.clamp(max=W - 1), (y - dist[..., None]).clamp(0, W - 1)
    if flat is None:
        shape = y.shape
        a = u8.gather(1, a.view(shape[0], -1)).view(shape)
        b = u8.gather(1, b.view(shape[0], -1)).view(shape)
    else:
        u8f = u8.view(-1)
        a, b = u8f[flat[:, None] + a], u8f[flat[:, None] + b]
    mm = (y < lim[..., None] + 3) & (a != b)
    return torch.where(mm, k, win).min(-1).values


def _mismatch(u8, pos, dist, act, lim):
    """First x >= pos with a 4-byte word mismatch between pos and pos - dist
    (lim if none before lim), for (B, K) evaluations on the (B, W) rows
    u8: the first mismatching byte y in [pos, lim + 3) gives x = max(pos,
    y - 3). One 128-byte window for all evaluations, then windows 4x wider
    for the few still equal."""
    win = SEG
    first = _first_mismatch(u8, None, pos, dist, lim, win)
    X = torch.where(first < win, torch.maximum(pos, pos + first - 3), lim)
    more = act & (first >= win) & (pos + win < lim + 3)
    if not bool(more.any()):
        return X
    B, K = pos.shape
    rows = torch.arange(B, device=u8.device)[:, None].expand(B, K)
    X, pos, dist, lim = (t.flatten() for t in (X, pos, dist, lim))
    idx = torch.nonzero(more.flatten()).flatten()
    base = rows.flatten() * u8.shape[1]
    start = pos[idx] + win
    while idx.numel():
        win *= 4
        first = _first_mismatch(u8, base[idx], start, dist[idx], lim[idx],
                                win)
        hit = first < win
        X[idx[hit]] = torch.maximum(pos[idx[hit]], (start + first)[hit] - 3)
        keep = ~hit & (start + win < lim[idx] + 3)
        idx, start = idx[keep], start[keep] + win
    return X.view(B, K)


CHECK_EVERY = 16              # parse steps between two termination checks


def parse_tokens_plain(data, lens, maps, cfg: EncCfg):
    """The plain PyTorch version of parse_tokens, the mirror p2_reference:
    vectorised over blocks, a Python loop over tokens. Each step evaluates
    every map at the lazy positions s..s+lazy of every block at once
    (their first word mismatch by _mismatch), then picks, steps lazily and
    back-extends as the mirror does; a block that has finished takes masked
    steps until the next termination check."""
    _check_data(data, lens, cfg)
    _check_maps(maps, data, cfg.ncand, cfg)
    dev, B, n, M = data.device, data.shape[0], cfg.n, cfg.ncand
    T = cfg.max_tokens
    tok = torch.zeros((B, T + 1, 3), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return tok[:, :T], counts.to(torch.int32)
    mp = maps.to(torch.int64)
    if cfg.far:
        mp[:, M - 1] = torch.where(mp[:, M - 1] > 0,
                                   mp[:, M - 1] + cfg.far_dist - 1, 0)
    anyc = (mp > 0).any(1)
    ar = torch.arange(n, device=dev)
    nxt = torch.where(anyc, ar, n).flip(1).cummin(1).values.flip(1)
    nxt = torch.cat([nxt, torch.full((B, 1), n, device=dev)], 1)
    lens64 = lens.to(torch.int64)
    lim = lens64 - LASTLITERALS
    live = lens64 >= LIZARD_MIN_LENGTH
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    L1 = cfg.lazy + 1
    steps = torch.arange(L1, device=dev)
    mids = torch.arange(M, device=dev)[None, :, None]
    back = torch.arange(SEG, device=dev)
    slot0 = torch.arange(B, device=dev) * (T + 1)
    limx = lim[:, None].expand(B, M * L1)
    far_m = M - 1 if cfg.far else -1
    step_no = 0
    while True:
        s0 = nxt.gather(1, cur.clamp(max=n)[:, None])[:, 0]
        act = live & (s0 < n)
        if step_no % CHECK_EVERY == 0 and not bool(act.any()):
            break
        step_no += 1
        s0 = torch.where(act, s0, 0)
        seg_end = ((s0 & ~(SEG - 1)) + SEG)[:, None, None]
        pos = (s0[:, None] + steps).clamp(max=n - 1)            # (B, L+1)
        posx = pos[:, None, :].expand(B, M, L1)
        D = mp.gather(2, posx)                                  # (B, M, L+1)
        has = ((D > 0) & (D <= posx) & act[:, None, None]
               & ((s0 % SEG)[:, None] < SEG - steps)[:, None, :])
        X = _mismatch(data, posx.reshape(B, -1), D.view(B, -1),
                      has.view(B, -1), limx).view(B, M, L1)
        limv = lim[:, None, None]
        ML = torch.where(X >= limv, limv - posx,
                         torch.minimum(X - posx + 3, limv - posx))
        V = torch.where(X >= seg_end, seg_end - posx + 3, ML)
        if far_m >= 0:
            has[:, far_m] &= V[:, far_m] >= MM_LONGOFF
        V = torch.where(has, V, -1)
        vb = V.max(1).values                                    # (B, L+1)
        mi = torch.where(V == vb[:, None], mids, M).min(1).values
        pml = ML.gather(1, mi[:, None])[:, 0]
        pd = D.gather(1, mi[:, None])[:, 0]
        v1, ml, d, s = vb[:, 0], pml[:, 0], pd[:, 0], s0
        found = act & (v1 >= 0)
        for step in range(1, L1):
            take = found & (vb[:, step] > v1 + (s0 + step - s))
            s = torch.where(take, s0 + step, s)
            d = torch.where(take, pd[:, step], d)
            ml = torch.where(take, pml[:, step], ml)
            v1 = torch.where(take, vb[:, step], v1)
        floor = torch.maximum(torch.maximum(cur, d), s & ~(SEG - 1))
        y = s[:, None] - 1 - back                               # (B, 128)
        stop = ((y < floor[:, None])
                | (data.gather(1, y.clamp(min=0))
                   != data.gather(1, (y - d[:, None]).clamp(min=0))))
        bk = s - torch.where(stop, back, SEG).min(1).values
        over = found & (counts >= T)            # cannot happen on valid maps
        slot = torch.where(found & ~over, counts, T)
        tok.view(-1, 3).index_copy_(0, slot0 + slot, torch.stack(
            [bk, ml + s - bk, d], 1).to(torch.int32))
        counts = torch.where(over, -1, counts + (found & ~over))
        live &= ~over
        cur = torch.where(act, torch.where(found, s + ml, s0 + 1), cur)
    return tok[:, :T], counts.to(torch.int32)


def token_arrays(tok, counts) -> list[tuple[np.ndarray, ...]]:
    """Per block, the (st, ml, off) int64 numpy arrays of a parse_tokens
    result, in parse order. Copies the counts, then only the used prefix of
    the token slots, to the host."""
    with profiling.span("tokens", "device"):
        profiling.count_bytes("d2h_bytes", counts)
        c = counts.cpu().numpy()
        if (c < 0).any():
            raise RuntimeError(f"parse_tokens overflowed its token slots in "
                               f"block {int(np.flatnonzero(c < 0)[0])}")
        used = int(c.max(initial=0))
        head = tok[:, :used]
        profiling.count_bytes("d2h_bytes", head)
        t = head.cpu().numpy().astype(np.int64)
        return [(t[b, :k, 0], t[b, :k, 1], t[b, :k, 2])
                for b, k in enumerate(c)]


# ------------------------------------------------ emission and container

def assemble_block(data, flags, lits, off16=b"", huff=False, off24=b"",
                   blobs=None):
    """Inner-block container (Lizard_writeBlock + Lizard_writeStream,
    lizard_compress.c:141-250): a header byte of per-stream Huffman bits,
    then the streams len/off16/off24/flags/literals; flags and literals
    longer than HUF_MIN_STREAM_LEN are Huffman-coded when huff=True and the
    reference's gain gates pass; a stored block when the total gain is too
    small. The Huff0 blob of such a stream is blobs[stream] (a mapping made
    by huf_compress_batch, None or b"" = not coded) or, with blobs=None, the
    native Huff0's."""

    def write_stream(out, stream, use_huff):
        if use_huff and len(stream) > HUF_MIN_STREAM_LEN:
            comp = (runtime.huf_compress(bytes(stream)) if blobs is None
                    else blobs[bytes(stream)])
            if comp and minimal_huff_gain(len(comp)) < len(stream):
                out += len(stream).to_bytes(3, "little")
                out += len(comp).to_bytes(3, "little")
                out += comp
                return 1
        out += len(stream).to_bytes(3, "little")
        out += bytes(stream)
        return 0

    body = bytearray([0])
    write_stream(body, b"", False)                    # lens: empty
    body[0] += write_stream(body, off16, False) * FLAG_OFFSET16
    body[0] += write_stream(body, off24, False) * FLAG_OFFSET24
    body[0] += write_stream(body, flags, huff) * FLAG_FLAGS
    body[0] += write_stream(body, lits, huff) * FLAG_LITERALS
    sum_len = len(flags) + len(lits) + len(off16) + len(off24)
    if (len(lits) < 16 or sum_len + 5 * 3 + 1 > len(data)
            or minimal_block_gain(len(body)) > len(data)):
        return (bytes([FLAG_UNCOMPRESSED]) + len(data).to_bytes(3, "little")
                + bytes(data))
    return bytes(body)


def emit_streams(d, st, ml, off, level) -> tuple[bytes, bytes, bytes, bytes]:
    """The level's codewords of one block's token arrays, by the native
    emitters: (flags, literals, off16, off24)."""
    if level // 10 in (2, 4):                         # LIZv1 codewords
        if len(off) and int(np.max(off)) >= 65536:    # the off24 class
            return runtime.emit_liz_far(d, st, ml, off)
        return (*runtime.emit_liz(d, st, ml, off), b"")
    return (*runtime.emit_lz4(d, st, ml, off), b"", b"")   # fastLZ4


def huffman_level(level: int) -> bool:
    """Levels 30-49 Huffman-code the flags and literals streams."""
    return level // 10 in (3, 4)


def huf_candidates(emitted) -> list[bytes]:
    """The streams of emitted blocks (emit_streams results) that
    assemble_block Huffman-codes at levels 30-49: flags and literals longer
    than HUF_MIN_STREAM_LEN."""
    return [s for e in emitted for s in e[:2] if len(s) > HUF_MIN_STREAM_LEN]


def emit_inner(d, st, ml, off, level):
    """Serialize one block's token arrays into the level's codewords (the
    native emitters) and its container (the native Huff0 at 30-49).
    Returns the inner block without the level byte."""
    flags, lits, off16, off24 = emit_streams(d, st, ml, off, level)
    return assemble_block(d, flags, lits, off16, huffman_level(level), off24)


# ------------------------------------------------------------ entry points

def encode_blocks_lanes(blocks, level=10, cfg: EncCfg = None, device=None,
                        entropy: str = "gpu"):
    """Compress blocks of up to cfg.n (128 KB) bytes each on `device` (the
    card unless device="cpu"), GROUP blocks per device batch: pack and copy
    to the device, match_find, chain_walk (chain tiers), parse_tokens, the
    tokens back to the host, the native emitters, then at 30-49 the Huff0
    stage of the batch's flags and literals streams, and the containers.
    entropy="gpu" (the default) codes every candidate stream of a batch in
    one huf_pack call on `device` (ops/enc_huf.py); entropy="host" codes
    each with the native Huff0. Both give the same bytes. All four level
    families 10-49. Returns one stream (level byte + inner block) per block,
    decodable by liblizard and by this package's decoders."""
    if entropy not in ("gpu", "host"):
        raise ValueError(f"entropy must be 'gpu' or 'host', not {entropy!r}")
    if cfg is None:
        cfg = cfg_for_level(level)
    dev = resolve_device(device)
    huff = huffman_level(level)
    out = []
    for base in range(0, len(blocks), GROUP):
        part = blocks[base:base + GROUP]
        data, lens = pack_blocks(part, cfg, dev)
        maps = match_find(data, lens, cfg)
        if cfg.chain:
            maps = chain_walk(data, lens, maps, cfg)
        toks = token_arrays(*parse_tokens(data, lens, maps, _parse_cfg(cfg)))
        with profiling.span("emit", "host"):
            emitted = [emit_streams(d, *t, level) for d, t in zip(part, toks)]
        blobs = None
        if huff and entropy == "gpu":
            with profiling.span("huf_plan", "host"):
                cands = huf_candidates(emitted)
            blobs = dict(zip(cands, huf_compress_batch(cands, dev)))
        with profiling.span("assemble", "host"):
            for d, (flags, lits, off16, off24) in zip(part, emitted):
                out.append(bytes([level]) + assemble_block(
                    d, flags, lits, off16, huff, off24, blobs))
    return out


def encode_streams_lanes(datas, level=10, cfg: EncCfg = None, device=None,
                         entropy: str = "gpu"):
    """Compress buffers of any size: each a level byte followed by the inner
    blocks of its cfg.n-byte chunks, compressed independently in one batch
    (the chunking of lizard_tpu/ops/encode_tpu.py::encode_streams_tpu);
    `entropy` as in encode_blocks_lanes."""
    if cfg is None:
        cfg = cfg_for_level(level)
    chunks, spans = [], []
    for d in datas:
        s0 = len(chunks)
        chunks += [d[i:i + cfg.n] for i in range(0, len(d), cfg.n)] or [b""]
        spans.append((s0, len(chunks)))
    inner = [b[1:] for b in encode_blocks_lanes(chunks, level, cfg, device,
                                                entropy)]
    return [bytes([level]) + b"".join(inner[a:b]) for a, b in spans]
