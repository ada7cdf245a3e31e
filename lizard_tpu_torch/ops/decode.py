"""Batched Lizard block decode in plain PyTorch operations: the port of
lizard_tpu/ops/decode.py, the JAX package's all-XLA decoder. That module is
plain jnp/lax code outside any Pallas kernel, so this one is plain tensor
operations on the caller's device, with no kernel of its own.

Three phases, batched struct-of-arrays over inner blocks:

A. token parse: the only sequential dependency is the literal-stream cursor.
   The JAX `lax.scan` carries every token field through max_steps + 1
   steps; here a Python loop of max_steps + 1 steps over [B] tensors
   carries the cursor alone (on the card a step costs the launches of its
   ~25-30 operations, with no host synchronisation), and each token's
   fields are then read at its cursor for every step at once;
B. expansion: per-output-byte source pointers from one scatter of token
   starts and a cumsum over the compact output: literals point into the flat
   literal tensor (encoded negative), match bytes point `offset` back;
C. resolution: match chains collapse by pointer doubling (ceil(log2 N)
   gather rounds); a final gather fetches the literal bytes.

Every block of every stream of the batch decodes into one compact output,
so the window references of a stream's inner blocks resolve by themselves.
As in the JAX module, input is assumed well formed: every index is clamped
(`jnp.take(..., mode="clip")`), corruption is not diagnosed.
"""

import numpy as np
import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.format.levels import Codewords
from lizard_tpu_torch.ops.split import (
    STREAMS, BlockBatch, finalize, new_accumulator, split_stream)

MINMATCH = 4
GUARD = 8  # flat tensors are padded so speculative reads stay in range


def _bytes(t, pos, k: int):
    """t[pos + 0 .. pos + k - 1] (any shape of pos; k bytes on a new last
    dimension), each index clamped into t."""
    idx = pos.unsqueeze(-1) + torch.arange(k, device=pos.device)
    return t[idx.clamp_(0, t.numel() - 1)]


def _ext_value(b):
    """The value of the <254 / 254+LE16 / 255+LE24 length extension whose
    bytes are b[..., 0:4] (doc/lizard_Block_format.md:91-96)."""
    b0 = b[..., 0]
    v = (b[..., 1] | b[..., 2] << 8
         | torch.where(b0 == 255, b[..., 3] << 16, 0))
    return torch.where(b0 < 254, b0, v)


def _ext_len_table(device) -> torch.Tensor:
    """[256] int64: the bytes of a length extension by its first byte (1,
    or 3 after 254, 4 after 255); one gather a lookup in the loop."""
    t = torch.ones(256, dtype=torch.int64)
    t[254], t[255] = 3, 4
    return t.to(device)


def _steps(flags, flags_off, n_tokens, max_steps: int, inactive: int):
    """The per-step state that no cursor decides, for every step at once:
    (token [B, T+1], its flags byte or `inactive` past the block's tokens;
    active, the step reads a token; trailing, the step is the block's
    trailing-literals pseudo-token)."""
    n_tokens = n_tokens.long()
    s = torch.arange(max_steps + 1, device=flags_off.device)
    active = s[None, :] < n_tokens[:, None]
    trailing = s[None, :] == n_tokens[:, None]
    token = _bytes(flags, flags_off.long(), max_steps + 1).long()
    return torch.where(active, token, inactive), active, trailing


def _walk(lit, start, end, trailing, advance):
    """The one sequential part of the parse: the literal-stream cursor of
    every block at the start of each step. `advance(b, s, p)` gives the
    cursor after step s's token from p, the cursor at its start, and b,
    the 4 bytes at p; the trailing pseudo-token moves the cursor to `end`.
    One loop step a token, vectorised over the blocks; it never
    synchronises with the host."""
    B, T1 = trailing.shape
    cursors = torch.empty((B, T1), dtype=torch.int64, device=start.device)
    four = torch.arange(4, device=start.device)
    p = start
    for s in range(T1):
        cursors[:, s] = p
        b = lit[(p[:, None] + four).clamp_(0, lit.numel() - 1)]
        p = torch.where(trailing[:, s], end, advance(b, s, p))
    return cursors


def _byte(lit, p):
    """lit[p], p clamped into lit."""
    return lit[p.clamp(0, lit.numel() - 1)]


def token_parse_lz4(flags, lit, flags_off, n_tokens, lit_off, lit_len,
                    max_steps: int):
    """Phase A for fastLZ4 codewords (lib/lizard_decompress_lz4.h:41-153).
    Returns per-token (ll, ml, off, lit_start) int64 tensors of shape
    [B, max_steps + 1] on flags' device; the step after a block's last
    token is its trailing-literals pseudo-token. A row with n_tokens = -1
    (padding) yields zeros. The loop carries the literal cursor alone;
    every value of a token is then read at its cursor for all steps at
    once."""
    token, active, trailing = _steps(flags, flags_off, n_tokens, max_steps,
                                     0)
    lit = lit.long()
    lit_off = lit_off.long()
    end = lit_off + lit_len.long()
    ext_len = _ext_len_table(lit.device)
    ll0, ml0 = token & 15, token >> 4
    has_ll = active & (ll0 == 15)
    has_ml = active & (ml0 == 15)
    two = 2 * active
    ml_ext = has_ml.long()

    def advance(b, s, p):
        # literal length (and its extension), the offset, the match length
        # extension's bytes
        p = p + torch.where(has_ll[:, s], _ext_value(b) + 15
                            + ext_len[b[:, 0]], ll0[:, s]) + two[:, s]
        return p + ml_ext[:, s] * ext_len[_byte(lit, p)]

    cur = _walk(lit, lit_off, end, trailing, advance)
    b = _bytes(lit, cur, 4)
    ll = torch.where(has_ll, _ext_value(b) + 15, ll0)
    lit_start = cur + has_ll * ext_len[b[..., 0]]
    b = _bytes(lit, lit_start + active * ll, 6)
    off = b[..., 0] | b[..., 1] << 8
    ml = torch.where(has_ml, _ext_value(b[..., 2:]) + 15, ml0) + MINMATCH
    t_ll = end[:, None] - (lit_start + active * ll + two
                           + has_ml * ext_len[b[..., 2]])
    return (torch.where(trailing, t_ll, active * ll), active * ml,
            active * off, (trailing | active) * lit_start)


def token_parse_liz(flags, lit, off16, off24, flags_off, n_tokens, lit_off,
                    lit_len, off16_off, off24_off, max_steps: int):
    """Phase A for LIZv1 codewords (lib/lizard_decompress_liz.h:50-209): 4
    token classes, the repeat offset, separate offset streams. Outputs as
    token_parse_lz4; a step past the tokens reads token 255, a harmless
    short token, as the JAX parse does. The loop carries the literal cursor
    alone; the offset cursors advance by the token classes alone, so they
    and the repeat offset are prefix sums and a running last value over
    the steps."""
    token, active, trailing = _steps(flags, flags_off, n_tokens, max_steps,
                                     255)
    lit = lit.long()
    lit_off = lit_off.long()
    end = lit_off + lit_len.long()
    is_short = token >= 32          # [F_MMMM_LLL]
    is_rep = is_short & (token >= 128)
    is_long31 = token == 31         # 24-bit offset, extended ML
    is_long = ~is_short & ~is_long31  # tokens 0..30
    ll0 = (active & is_short) * (token & 7)
    mls = (token >> 3) & 15
    has_ll = active & is_short & (ll0 == 7)
    has_ml = active & is_short & (mls == 15)
    # token 31's match-length extension comes before its 24-bit offset
    has_ext = has_ml | (active & is_long31)
    n_ext = has_ext.long()
    ext_len = _ext_len_table(lit.device)

    def advance(b, s, p):
        p = p + torch.where(has_ll[:, s], _ext_value(b) + 7
                            + ext_len[b[:, 0]], ll0[:, s])
        return p + n_ext[:, s] * ext_len[_byte(lit, p)]

    cur = _walk(lit, lit_off, end, trailing, advance)
    b = _bytes(lit, cur, 4)
    ll = torch.where(has_ll, _ext_value(b) + 7, ll0)
    lit_start = cur + has_ll * ext_len[b[..., 0]]
    b = _bytes(lit, lit_start + ll, 4)
    ext = _ext_value(b)
    t_ll = end[:, None] - (lit_start + ll + has_ext * ext_len[b[..., 0]])

    # offsets: each stream's cursor is its start plus the bytes that the
    # steps before took; the repeat offset is the last one read
    use16 = active & is_short & ~is_rep
    use24 = active & (is_long | is_long31)
    n16, n24 = use16.long(), use24.long()
    o16 = off16_off.long()[:, None] + 2 * (torch.cumsum(n16, 1) - n16)
    o24 = off24_off.long()[:, None] + 3 * (torch.cumsum(n24, 1) - n24)
    b16, b24 = _bytes(off16, o16, 2).long(), _bytes(off24, o24, 3).long()
    new = torch.where(use16, b16[..., 0] | b16[..., 1] << 8,
                      b24[..., 0] | b24[..., 1] << 8 | b24[..., 2] << 16)
    steps = torch.arange(token.shape[1], device=token.device)
    last = torch.cummax(torch.where(use16 | use24, steps, -1), 1).values
    last_off = (last >= 0) * new.gather(1, last.clamp(min=0))

    ml = torch.where(is_short, torch.where(has_ml, ext + 15, mls),
                     torch.where(is_long31, ext + 31 + 16, token + 16))
    return (torch.where(trailing, t_ll, ll), active * ml, active * last_off,
            (trailing | active) * lit_start)


def resolve_output(ll, ml, off, lit_start, n_tokens, lit_flat,
                   total_out: int, max_tokens_total: int):
    """Phases B+C: per-token tensors [B, T+1] -> (decompressed bytes, uint8
    [total_out], compact, blocks concatenated in batch order; per-block
    decoded lengths, int64 [B]). Tokens of rank max_tokens_total or more
    land in a spare slot that is never read (the JAX scatter's "drop");
    token starts at total_out or past it mark nothing."""
    dev = ll.device
    B, T1 = ll.shape
    M = max_tokens_total
    n_tokens = n_tokens.long()
    t = torch.arange(T1, device=dev)
    tok_valid = t[None, :] <= n_tokens[:, None]

    seq_len = torch.where(tok_valid, ll + ml, 0)
    # block output start = exclusive cumsum of block output lengths
    blk_len = seq_len.sum(1)
    blk_start = torch.cumsum(blk_len, 0) - blk_len
    # token output start, in global compact coordinates
    tok_start = blk_start[:, None] + torch.cumsum(seq_len, 1) - seq_len

    # valid tokens as one dense list: rank = tokens before the block + t
    n1 = n_tokens + 1
    rank = (torch.cumsum(n1, 0) - n1)[:, None] + t[None, :]
    rank = torch.where(tok_valid & (seq_len > 0), rank, M).clamp_(max=M)
    table = torch.zeros((M + 1, 4), dtype=torch.int64, device=dev)
    table[rank.reshape(-1)] = torch.stack(
        (tok_start, ll, off, lit_start), -1).reshape(-1, 4)

    # segment id per output byte: a 1 at each token start, then a cumsum
    starts = torch.where(rank < M, tok_start, total_out).clamp_(max=total_out)
    marker = torch.zeros(total_out + 1, dtype=torch.int64, device=dev)
    starts = starts.reshape(-1)
    marker.index_add_(0, starts, torch.ones_like(starts))
    seg = (torch.cumsum(marker[:total_out], 0) - 1).clamp_(0, M)

    pos = torch.arange(total_out, device=dev)
    s_start, s_ll, s_off, s_lit = table[seg].unbind(1)
    in_tok = pos - s_start
    src = torch.where(in_tok < s_ll, -(s_lit + in_tok) - 1, pos - s_off)

    # pointer doubling: chains of match references collapse in log rounds
    rounds = max(1, int(np.ceil(np.log2(max(total_out, 2)))))
    for _ in range(rounds):
        src = torch.where(src < 0, src, src[src.clamp(0, total_out - 1)])

    out = lit_flat[(-src - 1).clamp_(0, lit_flat.numel() - 1)]
    return out, blk_len


# the per-block columns the decoder reads (no off16/off24 lengths)
TABLE = ("flags_off", "flags_len", "lit_off", "lit_len", "off16_off",
         "off24_off")


def stage_batch(batch: BlockBatch, device) -> dict:
    """The batch on `device` as decode_batch reads it: the four flat
    streams, each padded with GUARD zero bytes, and the per-block offsets
    and lengths."""
    args = {k: torch.cat([getattr(batch, k), torch.zeros(
        GUARD, dtype=torch.uint8)]).to(device) for k in STREAMS}
    args.update({k: getattr(batch, k).to(device) for k in TABLE})
    return args


def token_parse(args: dict, family_liz: bool, max_steps: int):
    """Phase A of a staged batch (stage_batch) in its codeword family."""
    if family_liz:
        return token_parse_liz(
            args["flags"], args["literals"], args["off16"], args["off24"],
            args["flags_off"], args["flags_len"], args["lit_off"],
            args["lit_len"], args["off16_off"], args["off24_off"], max_steps)
    return token_parse_lz4(args["flags"], args["literals"], args["flags_off"],
                           args["flags_len"], args["lit_off"],
                           args["lit_len"], max_steps)


def decode_batch(batch: BlockBatch, total_out: int, device=None):
    """Decode a BlockBatch of one codeword family on `device` (the card
    unless device="cpu"): stage_batch, token_parse over batch.max_tokens + 1
    steps, resolve_output. Returns (bytes, uint8 [total_out]; per-block
    decoded lengths, int64 [n_blocks]), both on the device: the port of the
    JAX decode_batch, whose arrays come back to the host as numpy. Raises
    ValueError for a batch that mixes families (the JAX function decodes
    every block with the batch's one family)."""
    dev = resolve_device(device)
    if batch.n_blocks == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    if batch.block_family is not None:
        raise ValueError("decode_batch takes one codeword family a batch")
    args = stage_batch(batch, dev)
    parsed = token_parse(args, batch.codewords == Codewords.LIZv1,
                         batch.max_tokens)
    return resolve_output(*parsed, args["flags_len"], args["literals"],
                          int(total_out), int((batch.flags_len + 1).sum()))


def decompress_xla(src: bytes, max_out: int | None = None,
                   device=None) -> bytes:
    """One-shot `Lizard_decompress_safe` through decode_batch on `device`:
    the port of lizard_tpu/ops/decode.py::decompress_jax. `max_out` must be
    the exact decompressed size (the output's shape), as there; a stream
    that decodes to more comes back cut at max_out, as there."""
    if max_out is None:
        raise ValueError("decompress_xla requires max_out (the output size)")
    acc = new_accumulator()
    family = split_stream(src, acc, 0)
    out, blk_len = decode_batch(finalize(acc, family), max_out, device)
    n = int(blk_len.sum())
    return out[:n].cpu().numpy().tobytes()
