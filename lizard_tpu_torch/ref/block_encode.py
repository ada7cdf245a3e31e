"""Scalar Lizard compressor, replicating the reference parse decisions so the
compressed output is byte-identical (⇒ size parity is exact): the port's
copy of lizard_tpu/ref/block_encode.py. It stays serial Python on
bytes/bytearray/lists: hashes multiply by 64-bit primes and mask with
M32/M64, which only Python ints do exactly.

Structure mirrors (citations into the liblizard source tree):
- driver/serializer: lib/lizard_compress.c:130-250,472-547 (128 KB inner
  blocks, stream order len/off16/off24/flags/literals, uncompressed fallback
  via LIZARD_MINIMAL_BLOCK_GAIN)
- LZ4 sequence codeword: lib/lizard_compress_lz4.h:3-87
- LIZv1 sequence codeword: lib/lizard_compress_liz.h:43-179
- parsers: lib/lizard_parser_*.h (each function cites its source)

Hash/chain tables are modeled as zero-initialized (index 0 < lowLimit is
always rejected), matching the reference's fresh-allocation behavior.
"""

from lizard_tpu_torch.format.constants import (
    FLAG_FLAGS,
    FLAG_LITERALS,
    FLAG_UNCOMPRESSED,
    LIZARD_BLOCK_SIZE,
    LIZARD_DICT_SIZE,
    LIZARD_LAST_LONG_OFF,
    LIZARD_MAX_16BIT_OFFSET,
    MAX_SHORT_LITLEN,
    MAX_SHORT_MATCHLEN,
    MFLIMIT,
    MINMATCH,
    ML_MASK_LZ4,
    ML_RUN_BITS,
    MM_LONGOFF,
    PRIME4,
    PRIME5,
    PRIME6,
    PRIME7,
    RUN_BITS_LZ4,
    RUN_BITS_LIZ,
    RUN_MASK_LZ4,
    LASTLITERALS,
    LIZARD_MIN_LENGTH,
    SKIP_TRIGGER,
    minimal_block_gain,
    minimal_huff_gain,
)
from lizard_tpu_torch.format.levels import LEVELS, Codewords, Parser, validate_level

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
DICT = LIZARD_DICT_SIZE  # index offset: position i in src has index i+DICT


def _read32(b, i):
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16) | (b[i + 3] << 24)


def _read64(b, i):
    return int.from_bytes(b[i:i + 8], "little")


def hash4(u32, h):
    return ((u32 * PRIME4) & M32) >> (32 - h)


def hash5(u64, h):
    return (((u64 * PRIME5) & M64) << 24 & M64) >> (64 - h)


def hash6(u64, h):
    return (((u64 * PRIME6) & M64) << 16 & M64) >> (64 - h)


def hash7(u64, h):
    return (((u64 * PRIME7) & M64) << 8 & M64) >> (64 - h)


def hash_ptr(src, i, h_bits, mls):
    if mls == 5:
        return hash5(_read64(src, i), h_bits)
    if mls == 6:
        return hash6(_read64(src, i), h_bits)
    if mls == 7:
        return hash7(_read64(src, i), h_bits)
    return hash4(_read32(src, i), h_bits)


def _count(src, i, j, limit):
    """Lizard_count: equal-byte run of src[i..] vs src[j..], i capped at
    `limit` (lizard_common.h:475-490)."""
    n = 0
    while i + n < limit and src[j + n] == src[i + n]:
        n += 1
    return n


class Ctx:
    """Per-call compression state (subset of Lizard_stream_t)."""

    __slots__ = ("literals", "flags", "off16", "off24", "lens", "last_off",
                 "huff", "lit_freq", "flag_freq", "lit_sum", "flag_sum",
                 "log2_lit_sum", "log2_flag_sum", "lit_price_sum",
                 "cached_literals", "cached_price", "cached_lit_length",
                 "params", "level", "off24pos")

    def __init__(self, level, params):
        self.level = level
        self.params = params
        self.huff = level >= 30
        self.last_off = 0
        self.off24pos = 0
        self.lit_sum = 0
        self.flag_sum = 0
        self.lit_freq = [0] * 256
        self.flag_freq = [0] * 256
        self.log2_lit_sum = 0
        self.log2_flag_sum = 0
        self.lit_price_sum = 0
        self.cached_literals = None
        self.cached_price = 0
        self.cached_lit_length = 0

    def init_block(self):
        self.literals = bytearray()
        self.flags = bytearray()
        self.off16 = bytearray()
        self.off24 = bytearray()
        self.lens = bytearray()
        self.last_off = 0


def _highbit32(v):
    return v.bit_length() - 1


def _set_log2_prices(ctx):
    ctx.log2_lit_sum = _highbit32(ctx.lit_sum + 1)
    ctx.log2_flag_sum = _highbit32(ctx.flag_sum + 1)


def rescale_freqs(ctx):
    """Lizard_rescaleFreqs (lizard_compress_liz.h:10-40)."""
    ctx.cached_literals = None
    ctx.cached_price = ctx.cached_lit_length = 0
    ctx.lit_price_sum = 0
    if ctx.lit_sum == 0:
        ctx.lit_sum = 2 * 256
        ctx.flag_sum = 2 * 256
        for u in range(256):
            ctx.lit_freq[u] = 2
            ctx.flag_freq[u] = 2
    else:
        ctx.lit_sum = 0
        ctx.flag_sum = 0
        for u in range(256):
            ctx.lit_freq[u] = 1 + (ctx.lit_freq[u] >> 5)
            ctx.lit_sum += ctx.lit_freq[u]
            ctx.flag_freq[u] = 1 + (ctx.flag_freq[u] >> 5)
            ctx.flag_sum += ctx.flag_freq[u]
    _set_log2_prices(ctx)


def _emit_length(stream: bytearray, length: int) -> None:
    """<254 / 254+LE16 / 255+LE24 extension (lizard_compress_lz4.h:19-24)."""
    if length >= (1 << 16):
        stream.append(255)
        stream += length.to_bytes(3, "little")
    elif length >= 254:
        stream.append(254)
        stream += (length & 0xFFFF).to_bytes(2, "little")
    else:
        stream.append(length)


def encode_seq_lz4(ctx: Ctx, src, anchor, ip, match_length, match_idx):
    """Lizard_encodeSequence_LZ4 (lizard_compress_lz4.h:3-71).
    Returns new (ip, anchor)."""
    lit_len = ip - anchor
    token_pos = len(ctx.flags)
    ctx.flags.append(0)

    if lit_len >= RUN_MASK_LZ4:
        ctx.flags[token_pos] = RUN_MASK_LZ4
        _emit_length(ctx.literals, lit_len - RUN_MASK_LZ4)
    else:
        ctx.flags[token_pos] = lit_len

    ctx.literals += src[anchor:ip]

    offset = ip - match_idx
    ctx.literals += offset.to_bytes(2, "little")

    ml = match_length - MINMATCH
    if ml >= ML_MASK_LZ4:
        ctx.flags[token_pos] += ML_MASK_LZ4 << RUN_BITS_LZ4
        _emit_length(ctx.literals, ml - ML_MASK_LZ4)
    else:
        ctx.flags[token_pos] += ml << RUN_BITS_LZ4

    if ctx.huff:
        ctx.flag_freq[ctx.flags[token_pos]] += 1
        ctx.flag_sum += 1
        _set_log2_prices(ctx)

    ip += match_length
    return ip, ip


def encode_seq_liz(ctx: Ctx, src, anchor, ip, match_length, match_idx):
    """Lizard_encodeSequence_LIZv1 (lizard_compress_liz.h:43-165).
    match_idx == ip means rep-offset (offset encoded 0). Returns (ip, anchor).
    """
    offset = ip - match_idx
    lit_len = ip - anchor
    token_pos = len(ctx.flags)
    ctx.flags.append(0)

    if lit_len > 0 or offset < LIZARD_MAX_16BIT_OFFSET:
        if lit_len >= MAX_SHORT_LITLEN:
            ctx.flags[token_pos] = MAX_SHORT_LITLEN
            _emit_length(ctx.literals, lit_len - MAX_SHORT_LITLEN)
        else:
            ctx.flags[token_pos] = lit_len

        lit_start = len(ctx.literals)
        ctx.literals += src[anchor:ip]
        if ctx.huff:
            ctx.lit_sum += lit_len
            ctx.lit_price_sum += lit_len * ctx.log2_lit_sum
            for u in range(lit_start, lit_start + lit_len):
                b = ctx.literals[u]
                ctx.lit_price_sum -= _highbit32(ctx.lit_freq[b] + 1)
                ctx.lit_freq[b] += 1

        if offset >= LIZARD_MAX_16BIT_OFFSET:
            # literals carried by a zero-length rep token, then a new token
            ctx.flags[token_pos] += 1 << ML_RUN_BITS
            if ctx.huff:
                ctx.flag_freq[ctx.flags[token_pos]] += 1
                ctx.flag_sum += 1
            token_pos = len(ctx.flags)
            ctx.flags.append(0)

    if offset >= LIZARD_MAX_16BIT_OFFSET:
        assert match_length >= MM_LONGOFF
        if match_length - MM_LONGOFF >= LIZARD_LAST_LONG_OFF:
            ctx.flags[token_pos] = LIZARD_LAST_LONG_OFF
            _emit_length(ctx.literals, match_length - MM_LONGOFF - LIZARD_LAST_LONG_OFF)
        else:
            ctx.flags[token_pos] = match_length - MM_LONGOFF
        ctx.off24 += offset.to_bytes(3, "little")
        ctx.last_off = offset
        ctx.off24pos = ip
    else:
        if offset == 0:
            ctx.flags[token_pos] += 1 << ML_RUN_BITS
        else:
            assert offset >= 8 and match_length >= MINMATCH
            ctx.last_off = offset
            ctx.off16 += offset.to_bytes(2, "little")
        ml = match_length
        if ml >= MAX_SHORT_MATCHLEN:
            ctx.flags[token_pos] += MAX_SHORT_MATCHLEN << RUN_BITS_LIZ
            _emit_length(ctx.literals, ml - MAX_SHORT_MATCHLEN)
        else:
            ctx.flags[token_pos] += ml << RUN_BITS_LIZ

    if ctx.huff:
        ctx.flag_freq[ctx.flags[token_pos]] += 1
        ctx.flag_sum += 1
        _set_log2_prices(ctx)

    ip += match_length
    return ip, ip


def encode_last_literals(ctx: Ctx, src, anchor, ip):
    ctx.literals += src[anchor:ip]


# --------------------------------------------------------------- parsers ---

def parse_fast(ctx: Ctx, src, start, end, tables, hash_log, min_offset=8):
    """Lizard_compress_fast / _fastSmall (lib/lizard_parser_fast.h:41-196,
    lib/lizard_parser_fastsmall.h:34-189). The two differ only in hash table
    size; both use hash5 on 64-bit and enforce LIZARD_FAST_MIN_OFFSET=8."""
    htab = tables.hash
    window = ctx.params.window_log
    max_distance = (1 << window) - 1
    # indices are src positions + DICT (Lizard_init: base = src-16MB)
    low_limit = DICT if DICT + max_distance >= start + DICT else start + DICT - max_distance
    mflimit = end - MFLIMIT
    matchlimit = end - LASTLITERALS
    anchor = start
    ip = start

    def h_at(i):
        return hash5(_read64(src, i), hash_log)

    if end - start < LIZARD_MIN_LENGTH:
        encode_last_literals(ctx, src, anchor, end)
        return

    htab[h_at(ip)] = ip + DICT
    ip += 1
    forward_h = h_at(ip)

    while True:
        # --- find a match ---
        forward_ip = ip
        step = 1
        search_match_nb = 1 << SKIP_TRIGGER
        while True:
            h = forward_h
            ip = forward_ip
            forward_ip += step
            step = search_match_nb >> SKIP_TRIGGER
            search_match_nb += 1

            if forward_ip > mflimit:
                encode_last_literals(ctx, src, anchor, end)
                return

            match_index = htab[h]
            forward_h = h_at(forward_ip)
            htab[h] = ip + DICT

            if (match_index < low_limit or match_index >= ip + DICT
                    or match_index + max_distance < ip + DICT):
                continue
            m = match_index - DICT  # src position
            if ip - m >= min_offset and _read32(src, m) == _read32(src, ip):
                back = 0
                match_length = _count(src, ip + MINMATCH, m + MINMATCH, matchlimit)
                while (ip + back > anchor and m + back > 0
                       and src[ip + back - 1] == src[m + back - 1]):
                    back -= 1
                match_length -= back
                ip += back
                m += back
                break

        while True:
            ip, anchor = encode_seq_lz4(ctx, src, anchor, ip,
                                        match_length + MINMATCH, m)
            if ip > mflimit:
                encode_last_literals(ctx, src, anchor, end)
                return

            htab[h_at(ip - 2)] = ip - 2 + DICT
            match_index = htab[h_at(ip)]
            htab[h_at(ip)] = ip + DICT
            if (match_index >= low_limit and match_index < ip + DICT
                    and match_index + max_distance >= ip + DICT):
                m = match_index - DICT
                if ip - m >= min_offset and _read32(src, m) == _read32(src, ip):
                    match_length = _count(src, ip + MINMATCH, m + MINMATCH, matchlimit)
                    continue  # immediate next match at same position
            break

        ip += 1
        forward_h = h_at(ip)


class Tables:
    """Zero-initialized hash/chain tables shared across inner blocks."""

    def __init__(self, params):
        self.hash = [0] * (1 << params.hash_log)
        self.hash3 = [0] * (1 << params.hash_log3) if params.hash_log3 else None
        self.chain = None
        if params.content_log:
            self.chain = [0] * (1 << params.content_log)
        self.next_to_update = DICT


# ---------------------------------------------------------------- driver ---

def _write_stream(out: bytearray, stream: bytes, use_huff: bool) -> int:
    """Lizard_writeStream (lizard_compress.c:141-183). Returns the flag bit
    multiplier (1 if Huffman-coded)."""
    if use_huff and len(stream) > 1024:
        from lizard_tpu_torch.ref.huf_encode import huf_compress
        comp = huf_compress(bytes(stream))
        if comp is not None and len(comp) > 0 and minimal_huff_gain(len(comp)) < len(stream):
            out += len(stream).to_bytes(3, "little")
            out += len(comp).to_bytes(3, "little")
            out += comp
            return 1
    out += len(stream).to_bytes(3, "little")
    out += stream
    return 0


def _write_block(ctx: Ctx, src, block_start, input_size, out: bytearray) -> None:
    """Lizard_writeBlock (lizard_compress.c:186-250)."""
    sum_len = (len(ctx.flags) + len(ctx.literals) + len(ctx.lens)
               + len(ctx.off16) + len(ctx.off24))

    def write_uncompressed():
        out.append(FLAG_UNCOMPRESSED)
        out.extend(input_size.to_bytes(3, "little"))
        out.extend(src[block_start:block_start + input_size])

    if len(ctx.literals) < 16 or sum_len + 5 * 3 + 1 > input_size:
        write_uncompressed()
        return

    header_pos = len(out)
    out.append(0)
    huff = ctx.huff
    out[header_pos] += _write_stream(out, ctx.lens, False) * 16
    out[header_pos] += _write_stream(out, ctx.off16, False) * 4
    out[header_pos] += _write_stream(out, ctx.off24, False) * 8
    out[header_pos] += _write_stream(out, ctx.flags, huff) * FLAG_FLAGS
    out[header_pos] += _write_stream(out, ctx.literals, huff) * FLAG_LITERALS

    if minimal_block_gain(len(out) - header_pos) > input_size:
        del out[header_pos:]
        write_uncompressed()


def compress_range(ctx: Ctx, tables, data, start: int, end: int) -> bytes:
    """Lizard_compress_generic over data[start:end] with window into
    data[:start] (lizard_compress.c:472-547). Returns one compressed stream
    (level byte + inner blocks). Ctx/tables state persists across calls,
    enabling Lizard_compress_continue-style linked blocks."""
    out = bytearray([ctx.level])
    pos = start
    while pos < end:
        part = min(LIZARD_BLOCK_SIZE, end - pos)
        if ctx.huff:
            rescale_freqs(ctx)
        ctx.init_block()
        _dispatch_parser(ctx, data, pos, pos + part, tables)
        _write_block(ctx, data, pos, part, out)
        pos += part
    return bytes(out)


def compress(data: bytes, level: int = 17, tables: "Tables | None" = None) -> bytes:
    """Lizard_compress_extState equivalent: fresh window, 1 level byte +
    inner blocks. Pass `tables` to model reuse of one state across calls
    (the reference does not clear tables between extState calls; only
    nextToUpdate is reset via Lizard_init)."""
    level = validate_level(level)
    params = LEVELS[level]
    ctx = Ctx(level, params)
    if tables is None:
        tables = Tables(params)
    else:
        tables.next_to_update = DICT  # Lizard_init (lizard_compress.c:334)
    return compress_range(ctx, tables, data, 0, len(data))


def _dispatch_parser(ctx, src, start, end, tables):
    p = ctx.params.parser
    if p == Parser.FAST_SMALL:
        parse_fast(ctx, src, start, end, tables, hash_log=12)
    elif p == Parser.FAST:
        parse_fast(ctx, src, start, end, tables, hash_log=18)
    elif p == Parser.NO_CHAIN:
        from lizard_tpu_torch.ref.parsers import parse_nochain
        parse_nochain(ctx, src, start, end, tables)
    elif p == Parser.HASH_CHAIN:
        from lizard_tpu_torch.ref.parsers import parse_hashchain
        parse_hashchain(ctx, src, start, end, tables)
    elif p == Parser.FAST_BIG:
        from lizard_tpu_torch.ref.parsers import parse_fastbig
        parse_fastbig(ctx, src, start, end, tables)
    elif p == Parser.PRICE_FAST:
        from lizard_tpu_torch.ref.parsers import parse_pricefast
        parse_pricefast(ctx, src, start, end, tables)
    elif p == Parser.LOWEST_PRICE:
        from lizard_tpu_torch.ref.parsers import parse_lowestprice
        parse_lowestprice(ctx, src, start, end, tables)
    else:
        from lizard_tpu_torch.ref.parser_optimal import parse_optimal
        parse_optimal(ctx, src, start, end, tables)
