"""Price models for the price-based parsers, replicating
Lizard_get_price_LZ4 (lib/lizard_compress_lz4.h:89-162) and
Lizard_get_price_LIZv1 (lib/lizard_compress_liz.h:182-301) exactly,
including the literal-price cache (whose staleness is observable: cached
partial sums were computed under older log2LitSum values). The port's copy
of lizard_tpu/ref/price.py.
"""

from lizard_tpu_torch.format.constants import (
    LIZARD_LAST_LONG_OFF,
    LIZARD_MAX_16BIT_OFFSET,
    MAX_SHORT_LITLEN,
    MAX_SHORT_MATCHLEN,
    MINMATCH,
    ML_MASK_LZ4,
    ML_RUN_BITS,
    MM_LONGOFF,
    RUN_BITS_LZ4,
    RUN_BITS_LIZ,
    RUN_MASK_LZ4,
)
from lizard_tpu_torch.format.levels import Parser

MAX_PRICE = 1 << 28
M64 = (1 << 64) - 1  # prices are size_t in the reference: arithmetic wraps
# mod 2^64, and this is observable (Lizard_more_profitable passes a negative
# pointer difference as size_t `literals`, lizard_parser_lowestprice.h:4-17)


def _highbit32(v):
    return v.bit_length() - 1


def _ext_price(length):
    if length >= (1 << 16):
        return 32
    if length >= 254:
        return 24
    return 8


def _lit_price_cached(ctx, src, ip, lit_length):
    """The cached literal price path (lizard_compress_liz.h:193-213).
    Literal run is src[ip-litLength : ip]; cache keys on its start."""
    literals = ip - lit_length
    if ctx.cached_literals == literals and lit_length >= ctx.cached_lit_length:
        additional = lit_length - ctx.cached_lit_length
        start2 = literals + ctx.cached_lit_length
        price = ctx.cached_price + additional * ctx.log2_lit_sum
        for u in range(additional):
            price -= _highbit32(ctx.lit_freq[src[start2 + u]] + 1)
        ctx.cached_price = price & 0xFFFFFFFF
        ctx.cached_lit_length = lit_length
    else:
        price = lit_length * ctx.log2_lit_sum
        for u in range(lit_length):
            price -= _highbit32(ctx.lit_freq[src[literals + u]] + 1)
        if lit_length >= 12:
            ctx.cached_literals = literals
            ctx.cached_price = price & 0xFFFFFFFF
            ctx.cached_lit_length = lit_length
    return price


def get_price_liz(ctx, rep, src, ip, lit_length, offset, match_length):
    """Lizard_get_price_LIZv1. `ip` is the position whose preceding
    lit_length bytes are the literals (used only on the huff path).
    lit_length is size_t in C: huge values (wrapped negatives) flow through
    the simple-price path with mod-2^64 arithmetic."""
    lit_length &= M64
    if ctx.huff and ctx.params.parser != Parser.LOWEST_PRICE:
        price = _lit_price_cached(ctx, src, ip, lit_length)
        huff_tokens = True
    else:
        price = (8 * lit_length) & M64
        huff_tokens = False

    token = 0
    if lit_length > 0 or offset < LIZARD_MAX_16BIT_OFFSET:
        if lit_length >= MAX_SHORT_LITLEN:
            token = MAX_SHORT_LITLEN
            price += _ext_price((lit_length - MAX_SHORT_LITLEN) & M64)
        else:
            token = lit_length
        if offset >= LIZARD_MAX_16BIT_OFFSET:
            token += 1 << ML_RUN_BITS
            if huff_tokens:
                price += ctx.log2_flag_sum - _highbit32(ctx.flag_freq[token & 0xFF] + 1)
            else:
                price += 8

    if offset >= LIZARD_MAX_16BIT_OFFSET:
        if match_length < MM_LONGOFF:
            return MAX_PRICE
        if match_length - MM_LONGOFF >= LIZARD_LAST_LONG_OFF:
            token = LIZARD_LAST_LONG_OFF
            price += _ext_price(match_length - MM_LONGOFF - LIZARD_LAST_LONG_OFF)
        else:
            token = match_length - MM_LONGOFF
        price += 24
    else:
        if offset == 0:
            token += 1 << ML_RUN_BITS
        else:
            if offset < 8:
                return MAX_PRICE
            if match_length < MINMATCH:
                return MAX_PRICE
            price += 16
        length = match_length
        if length >= MAX_SHORT_MATCHLEN:
            token += MAX_SHORT_MATCHLEN << RUN_BITS_LIZ
            price += _ext_price(length - MAX_SHORT_MATCHLEN)
        else:
            token += length << RUN_BITS_LIZ

    if offset > 0 or match_length > 0:
        offset_load = _highbit32(offset) if offset > 0 else -1
        if ctx.huff:
            price += (offset_load - 19) * 4 if offset_load >= 20 else 0
            price += 4 + (1 if match_length == 1 else 0)
        else:
            price += (offset_load - 15) * 4 if offset_load >= 16 else 0
            price += 6 + (1 if match_length == 1 else 0)
        if huff_tokens:
            price += ctx.log2_flag_sum - _highbit32(ctx.flag_freq[token & 0xFF] + 1)
        else:
            price += 8
    else:
        if huff_tokens:
            price += ctx.log2_flag_sum - _highbit32(ctx.flag_freq[token & 0xFF] + 1)

    return price & M64


def get_price_lz4(ctx, src, ip, lit_length, offset, match_length):
    """Lizard_get_price_LZ4 (lizard_compress_lz4.h:89-162). The huffman
    literal path is compiled out in the reference (price = 8*litLength)."""
    price = 8 * lit_length

    if lit_length >= RUN_MASK_LZ4:
        token = RUN_MASK_LZ4
        price += _ext_price(lit_length - RUN_MASK_LZ4)
    else:
        token = lit_length

    if offset:
        price += 16
        if offset < 8:
            return MAX_PRICE
        if match_length < MINMATCH:
            return MAX_PRICE
        length = match_length - MINMATCH
        if length >= ML_MASK_LZ4:
            token += ML_MASK_LZ4 << RUN_BITS_LZ4
            price += _ext_price(length - ML_MASK_LZ4)
        else:
            token += length << RUN_BITS_LZ4

    if ctx.huff:
        if offset > 0 or match_length > 0:
            price += 2
        price += ctx.log2_flag_sum - _highbit32(ctx.flag_freq[token & 0xFF] + 1)
    else:
        price += 8

    return price
