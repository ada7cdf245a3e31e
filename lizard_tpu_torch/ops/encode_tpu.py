"""The all-XLA fastLZ4 encoder in plain PyTorch operations: the port of
lizard_tpu/ops/encode_tpu.py. That module is plain jnp/lax code outside any
Pallas kernel, so this one is plain tensor operations on the caller's
device, with no kernel of its own. Its output is byte-identical to the JAX
module's.

1. Match finding by stable sort (no hash table): hash4 every position,
   stable-argsort by hash, so each position's sorted predecessor with the
   same hash is its nearest earlier occurrence; candidates are verified by a
   4-byte compare and extended by word compares.
2. Chunk-parallel greedy parse: matches are capped at their 128-byte chunk's
   end, so every chunk's greedy walk is independent; all chunks of all
   blocks walk together, CHUNK steps of one loop.
3. Gather-based emission: the chosen match starts become a token list (one
   more stable argsort), per-token stream sizes prefix-sum into offsets, and
   every byte of the literal stream finds its token by a binary search and
   gathers its value.

Blocks decode with liblizard and every decoder of this repo (the fastLZ4
container, lizard_compress.c:186-250; last-16-bytes-literal and
match-start-before-end-20 rules enforced). Every step works on each block's
row alone, so the bytes of a block do not depend on the batch it is in.
"""

import numpy as np
import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.format.constants import (
    FLAG_UNCOMPRESSED,
    LASTLITERALS,
    LIZARD_MIN_LENGTH,
    MFLIMIT,
    MINMATCH,
    minimal_block_gain,
)

N = 131072                  # padded block size (one 128 KB inner block)
CHUNK = 128                 # parse-chunk bytes (walk steps per block)
NCH = N // CHUNK
MAXTOK = N // MINMATCH      # token capacity
HASHLOG = 17
HMUL = 2654435761
EXT_ROUNDS = 34             # word-compare rounds: 4+4*33+3 >= CHUNK+3
RUN_MASK = 15
ML_MASK = 15
LMAX = N + N // 4           # literal-stream capacity of a block
BATCH = 32                  # blocks a device batch (any size: same bytes)


def _ext_len(v, present):
    return torch.where(present, torch.where(
        v < 254, 1, torch.where(v < (1 << 16), 3, 4)), 0)


def _ext_byte(v, elen, r):
    """Byte r of the length extension of v that takes elen bytes."""
    first = torch.where(elen == 1, v, torch.where(elen == 3, 254, 255))
    return torch.where(r == 0, first,
                       (v >> ((r - 1).clamp(0, 3) * 8)) & 255)


def _encode_batch(u8, n, min_offset: int = 8):
    """u8: (B, N) uint8, each row a block zero-padded; n: (B,) its lengths.
    Returns flags (B, MAXTOK) uint8, ntok (B,), lits (B, LMAX) uint8,
    lit_len (B,), last_end (B,) (the end of the last match), all on u8's
    device; the counts int64."""
    B = u8.shape[0]
    dev = u8.device
    pos = torch.arange(N, device=dev)[None, :].expand(B, N)
    n = n.long()
    nn = n[:, None]

    u = u8.long()
    w = (u | torch.roll(u, -1, 1) << 8 | torch.roll(u, -2, 1) << 16
         | torch.roll(u, -3, 1) << 24)
    h = ((w * HMUL) & 0xFFFFFFFF) >> (32 - HASHLOG)

    # nearest previous occurrence via stable sort (see module doc)
    sidx = torch.argsort(h, dim=1, stable=True)
    inv = torch.empty_like(sidx).scatter_(1, sidx, pos)
    hs = h.gather(1, sidx)
    prev = torch.roll(sidx, 1, 1)
    same = (hs == torch.roll(hs, 1, 1)) & (pos > 0)
    cand = torch.where(same, prev, -1).gather(1, inv)

    safe_c = cand.clamp(0, N - 1)
    off = pos - safe_c
    valid = ((cand >= 0) & (off >= min_offset) & (off <= 65535)
             & (w.gather(1, safe_c) == w)
             & (pos < nn - MFLIMIT) & (nn >= LIZARD_MIN_LENGTH))

    # word-compare extension, byte-exact via the first mismatching word
    ml = torch.full((B, N), MINMATCH, dtype=torch.int64, device=dev)
    live = valid
    extra = torch.zeros_like(ml)
    for r in range(1, EXT_ROUNDS):
        x = (w.gather(1, (pos + 4 * r).clamp(max=N - 1))
             ^ w.gather(1, (safe_c + 4 * r).clamp(max=N - 1)))
        eq = (x == 0) & live
        tz = torch.where((x & 0xFF) == 0, torch.where(
            (x & 0xFFFF) == 0, torch.where((x & 0xFFFFFF) == 0, 3, 2), 1), 0)
        extra = torch.where(live & ~eq, tz, extra)
        ml = ml + 4 * eq
        live = eq
    ml = ml + torch.where(live, 0, extra) * valid
    # cap: stay inside the chunk and leave the last 16 bytes literal
    ml = torch.minimum(ml, CHUNK - pos % CHUNK)
    ml = torch.minimum(ml, nn - LASTLITERALS - pos)
    has_m = valid & (ml >= MINMATCH)
    ml_m = torch.where(has_m, ml, 0)

    # chunk-parallel greedy walk: every chunk's cursor at once; a hit marks
    # its position in `chosen` (column CHUNK takes the steps that mark none)
    mlc = ml_m.reshape(B, NCH, CHUNK)
    p = torch.zeros((B, NCH, 1), dtype=torch.int64, device=dev)
    chosen = torch.zeros((B, NCH, CHUNK + 1), dtype=torch.bool, device=dev)
    for _ in range(CHUNK):
        m = mlc.gather(2, p.clamp(max=CHUNK - 1))
        act = p < CHUNK
        hit = act & (m >= MINMATCH)
        chosen.scatter_(2, torch.where(hit, p, CHUNK), True)
        p = p + torch.where(hit, m, act.long())
    chosen = chosen[:, :, :CHUNK].reshape(B, N)

    # tokenization
    ntok = chosen.sum(1)
    order = torch.argsort((~chosen).to(torch.uint8), dim=1,
                          stable=True)[:, :MAXTOK]
    tok_i = torch.arange(MAXTOK, device=dev)[None, :]
    tval = tok_i < ntok[:, None]
    starts = torch.where(tval, order, 0)
    mlt = torch.where(tval, ml_m.gather(1, starts), 0)
    offt = torch.where(tval, starts - safe_c.gather(1, starts), 1)
    ends = starts + mlt
    prev_end = torch.where(tok_i > 0, torch.roll(ends, 1, 1), 0)
    ll = torch.where(tval, starts - prev_end, 0)

    mlx = mlt - MINMATCH
    flags = torch.where(tval, ll.clamp(max=RUN_MASK)
                        | mlx.clamp(max=ML_MASK) << 4, 0).to(torch.uint8)

    vll = ll - RUN_MASK
    vml = mlx - ML_MASK
    ell = _ext_len(vll, tval & (ll >= RUN_MASK))
    eml = _ext_len(vml, tval & (mlx >= ML_MASK))
    tsz = torch.where(tval, ell + ll + 2 + eml, 0)
    tok_off = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                         torch.cumsum(tsz, 1)], 1)
    body_len = tok_off.gather(1, ntok[:, None])[:, 0]
    last_end = torch.where(
        ntok > 0, ends.gather(1, (ntok - 1).clamp(min=0)[:, None])[:, 0], 0)
    tail_ll = n - last_end
    lit_len = body_len + tail_ll

    # literal-stream emission: each output byte's token is the last whose
    # stream offset is <= the byte's (the JAX module's 15-step binary search
    # over tok_off[:MAXTOK], which is non-decreasing)
    o = torch.arange(LMAX, device=dev)[None, :].expand(B, LMAX).contiguous()
    j = torch.searchsorted(tok_off[:, :MAXTOK].contiguous(), o,
                           right=True) - 1
    in_body = o < body_len[:, None]
    jc = j.clamp(max=MAXTOK - 1)
    r = o - tok_off.gather(1, jc)

    ell_j = ell.gather(1, jc)
    ll_j = ll.gather(1, jc)
    pe_j = prev_end.gather(1, jc)
    off_j = offt.gather(1, jc)
    b_ell = _ext_byte(vll.gather(1, jc), ell_j, r)
    r2 = r - ell_j
    b_lit = u8.gather(1, (pe_j + r2).clamp(0, N - 1)).long()
    r3 = r2 - ll_j
    b_off = torch.where(r3 == 0, off_j & 255, off_j >> 8)
    b_eml = _ext_byte(vml.gather(1, jc), eml.gather(1, jc), r3 - 2)
    body = torch.where(r < ell_j, b_ell, torch.where(
        r2 < ll_j, b_lit, torch.where(r3 < 2, b_off, b_eml)))
    # tail literals
    rt = o - body_len[:, None]
    b_tail = u8.gather(1, (last_end[:, None] + rt).clamp(0, N - 1)).long()
    in_tail = ~in_body & (rt < tail_ll[:, None])
    lits = torch.where(in_body, body,
                       torch.where(in_tail, b_tail, 0)).to(torch.uint8)
    return flags, ntok, lits, lit_len, last_end


def _assemble(data, flags, nt, lits, ll) -> bytes:
    """One inner block (Lizard_writeBlock, lizard_compress.c:186): header
    byte (no Huffman stream), empty len/off16/off24 streams, the flags and
    literals streams; stored when the reference's gates say so."""
    body = bytearray([0])
    body += bytes(9)                            # len, off16, off24: empty
    for stream in (bytes(flags[:nt]), bytes(lits[:ll])):
        body += len(stream).to_bytes(3, "little") + stream
    if (ll < 16 or nt + ll + 5 * 3 + 1 > len(data)
            or minimal_block_gain(len(body)) > len(data)):
        return (bytes([FLAG_UNCOMPRESSED]) + len(data).to_bytes(3, "little")
                + bytes(data))
    return bytes(body)


def _inner_blocks(blocks, min_offset: int, device) -> list[bytes]:
    """Every block of at most N bytes through _encode_batch on `device`,
    BATCH blocks a call; one assembled inner block (header + 5 streams, or
    stored) per block."""
    res = []
    for base in range(0, len(blocks), BATCH):
        part = blocks[base:base + BATCH]
        u8 = np.zeros((len(part), N), np.uint8)
        n = np.zeros(len(part), np.int64)
        for k, d in enumerate(part):
            u8[k, :len(d)] = np.frombuffer(d, np.uint8)
            n[k] = len(d)
        flags, ntok, lits, lit_len, _ = _encode_batch(
            torch.from_numpy(u8).to(device), torch.from_numpy(n).to(device),
            min_offset)
        flags, ntok, lits, lit_len = (t.cpu().numpy() for t in (
            flags, ntok, lits, lit_len))
        res += [_assemble(d, flags[k], int(ntok[k]), lits[k],
                          int(lit_len[k])) for k, d in enumerate(part)]
    return res


def encode_blocks_tpu(blocks, level: int = 10, min_offset: int = 8,
                      device=None) -> list[bytes]:
    """Compress blocks of up to 128 KB each on `device` (the card unless
    device="cpu"). Returns one fastLZ4-container stream per block (level
    byte + one inner block). min_offset=8 mirrors LIZARD_FAST_MIN_OFFSET
    (lizard_compress.c:54): the reference decoder's wildcopy assumes it."""
    for d in blocks:
        if len(d) > N:
            raise ValueError("encode_blocks_tpu: block > 128 KB")
    dev = resolve_device(device)
    return [bytes([level]) + b
            for b in _inner_blocks(blocks, min_offset, dev)]


def encode_streams_tpu(datas, level: int = 10, min_offset: int = 8,
                       device=None) -> list[bytes]:
    """Compress buffers of any size: each becomes one stream of the level
    byte and the inner blocks of its 128 KB chunks, compressed independently
    (no match crosses an inner block). Every buffer's chunks go through the
    device in shared batches."""
    dev = resolve_device(device)
    chunks, spans = [], []
    for d in datas:
        s0 = len(chunks)
        chunks += [d[i:i + N] for i in range(0, len(d), N)] or [b""]
        spans.append((s0, len(chunks)))
    inner = _inner_blocks(chunks, min_offset, dev)
    return [bytes([level]) + b"".join(inner[a:b]) for a, b in spans]
