# Frozen copy of lizard_tpu_torch/ref/block_decode.py at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea, with its imports
# pointing into h100_bench.reference. Later changes to the program do not reach it.
"""Scalar decoder for the Lizard compressed-block stream (both codeword
families), bit-exact vs the reference decoder: the port's copy of
lizard_tpu/ref/block_decode.py, serial Python on bytes, the specification
the card's decoders (ops/lane_decode.py, ops/fuse.py) are graded against.

Semantics pinned against (citations into the liblizard source tree):
- stream container:  lib/lizard_decompress.c:115-264 (level byte, per-block
  header byte, stream order len/off16/off24/flags/literals, per-block
  last_off reset)
- LZ4 codewords:     lib/lizard_decompress_lz4.h:7-163
- LIZv1 codewords:   lib/lizard_decompress_liz.h:14-220
- length extension:  doc/lizard_Block_format.md:91-96 (first byte <254 ->
  value; ==254 -> LE16; ==255 -> LE24)
"""

from h100_bench.reference.constants import (
    FLAG_FLAGS,
    FLAG_LEN,
    FLAG_LITERALS,
    FLAG_OFFSET16,
    FLAG_OFFSET24,
    FLAG_UNCOMPRESSED,
    LIZARD_LAST_LONG_OFF,
    LIZARD_MAX_CLEVEL,
    LIZARD_MIN_CLEVEL,
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
from h100_bench.reference.levels import LEVELS, Codewords


from h100_bench.reference.errors import CorruptError  # noqa: F401 (re-export)


def _le24(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16)


def _le16(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8)


class _Stream:
    __slots__ = ("data", "pos", "end")

    def __init__(self, data, pos, end):
        self.data = data
        self.pos = pos
        self.end = end

    def remaining(self) -> int:
        return self.end - self.pos


def _read_length_ext(lit: _Stream, iend: int, base: int) -> int:
    """Read an extension length from the literals stream
    (lizard_decompress_liz.h:62-75 pattern). `iend` is literalsEnd;
    the reference requires literalsPtr <= iend-1 before the first byte."""
    if lit.pos > iend - 1:
        raise CorruptError("length ext past literals end")
    first = lit.data[lit.pos]
    if first >= 254:
        if first == 254:
            length = _le16(lit.data, lit.pos + 1)
            lit.pos += 2
        else:
            length = _le24(lit.data, lit.pos + 1)
            lit.pos += 3
    else:
        length = first
    lit.pos += 1
    return length + base


def _decode_block_lz4(streams, out: bytearray, window_base: int,
                      stop_at: int | None = None) -> None:
    """Token loop for the fastLZ4 family (lib/lizard_decompress_lz4.h).

    `out` holds all previously decoded output of this compressed stream;
    matches may reach back across inner-block boundaries (the window is the
    shared prefix). `window_base` is the lowest out-index matches may touch.
    stop_at: early-exit once len(out) reaches it, mid-token-loop
    (Lizard_decompress_safe_partial, lizard_decompress_lz4.h:82,144).
    """
    flags, lit = streams["flags"], streams["literals"]
    iend = lit.end

    while flags.pos < flags.end:
        if stop_at is not None and len(out) >= stop_at:
            return
        token = flags.data[flags.pos]
        flags.pos += 1

        # literal length (lz4: extension needs 5 readable bytes; the
        # reference checks literalsPtr <= iend-5, lizard_decompress_lz4.h:49)
        length = token & RUN_MASK_LZ4
        if length == RUN_MASK_LZ4:
            if lit.pos > iend - 5:
                raise CorruptError("lz4 litlen ext")
            length = _read_length_ext(lit, iend, RUN_MASK_LZ4)

        # copy literals (reference requires literalsPtr+length <= iend-(2+16))
        if lit.pos + length > iend - (2 + 16):
            raise CorruptError("lz4 literals overrun")
        out += lit.data[lit.pos:lit.pos + length]
        lit.pos += length

        # offset (LE16 from the *literals* stream, lizard_decompress_lz4.h:85)
        offset = _le16(lit.data, lit.pos)
        lit.pos += 2
        if offset == 0 or len(out) - offset < window_base:
            raise CorruptError("lz4 offset out of window")

        # match length
        length = token >> RUN_BITS_LZ4
        if length == ML_MASK_LZ4:
            if lit.pos > iend - 5:
                raise CorruptError("lz4 mlen ext")
            length = _read_length_ext(lit, iend, ML_MASK_LZ4)
        length += MINMATCH

        _copy_match(out, offset, length)

    # last literals: whatever remains of the literals stream
    out += lit.data[lit.pos:lit.end]
    lit.pos = lit.end


def _decode_block_liz(streams, out: bytearray, window_base: int,
                      stop_at: int | None = None) -> None:
    """Token loop for the LIZv1 family (lib/lizard_decompress_liz.h).

    last_off is reset at every inner-block boundary
    (lib/lizard_decompress.c:233). stop_at: early-exit once len(out)
    reaches it (Lizard_decompress_safe_partial semantics)."""
    flags, lit = streams["flags"], streams["literals"]
    off16, off24 = streams["off16"], streams["off24"]
    iend = lit.end
    last_off = 0  # stored positive here; reference stores negative

    while flags.pos < flags.end:
        if stop_at is not None and len(out) >= stop_at:
            return
        token = flags.data[flags.pos]
        flags.pos += 1

        if token >= 32:
            # [F_MMMM_LLL]
            length = token & MAX_SHORT_LITLEN
            if length == MAX_SHORT_LITLEN:
                length = _read_length_ext(lit, iend, MAX_SHORT_LITLEN)
            # reference checks literalsPtr <= iend-16 pre-copy
            # (lizard_decompress_liz.h:82); we additionally require the read
            # itself to stay in-stream (stricter only on corrupt input)
            if lit.pos > iend - 16 or lit.pos + length > iend:
                raise CorruptError("liz literals overrun")
            out += lit.data[lit.pos:lit.pos + length]
            lit.pos += length

            if token >> ML_RUN_BITS == 0:  # new 16-bit offset
                if off16.pos > off16.end:
                    raise CorruptError("off16 overrun")
                last_off = _le16(off16.data, off16.pos)
                off16.pos += 2
            # else: rep offset, keep last_off

            length = (token >> RUN_BITS_LIZ) & MAX_SHORT_MATCHLEN
            if length == MAX_SHORT_MATCHLEN:
                length = _read_length_ext(lit, iend, MAX_SHORT_MATCHLEN)
        elif token < LIZARD_LAST_LONG_OFF:
            # tokens 0..30: ML = token+16, 24-bit offset
            if off24.pos > off24.end - 3:
                raise CorruptError("off24 overrun")
            length = token + MM_LONGOFF
            last_off = _le24(off24.data, off24.pos)
            off24.pos += 3
        else:
            # token 31: ext ML (>=47), 24-bit offset read AFTER length
            length = _read_length_ext(lit, iend, 0)
            length += LIZARD_LAST_LONG_OFF + MM_LONGOFF
            if off24.pos > off24.end - 3:
                raise CorruptError("off24 overrun")
            last_off = _le24(off24.data, off24.pos)
            off24.pos += 3

        if last_off == 0:
            # zero-length rep "match" at block start (legal encoder output:
            # the literals-carrying token before a long-offset match)
            if length != 0:
                raise CorruptError("liz rep match with last_off==0")
        elif len(out) - last_off < window_base:
            raise CorruptError("liz offset out of window")
        _copy_match(out, last_off, length)

    out += lit.data[lit.pos:lit.end]
    lit.pos = lit.end


def _copy_match(out: bytearray, offset: int, length: int) -> None:
    """Overlap-correct LZ77 match copy (effect of Lizard_copy8/wildCopy16)."""
    if length == 0:
        return
    start = len(out) - offset
    if offset >= length:
        out += out[start:start + length]
    else:
        # overlapping: byte-replication semantics
        for i in range(length):
            out.append(out[start + i])


def _read_stream(src: bytes, ip: int, flag: int, huf_decode) -> tuple[_Stream, int]:
    """One stream: raw (LE24 len + bytes) or Huffman (LE24 orig + LE24 comp +
    blob), lib/lizard_decompress.c:72-112."""
    if not flag:
        if ip > len(src) - 3:
            raise CorruptError("stream header truncated")
        n = _le24(src, ip)
        start = ip + 3
        end = start + n
        if end > len(src):
            raise CorruptError("stream truncated")
        return _Stream(src, start, end), end
    # Huffman-compressed stream
    if ip > len(src) - 6:
        raise CorruptError("huf stream header truncated")
    orig_len = _le24(src, ip)
    comp_len = _le24(src, ip + 3)
    if ip + 6 + comp_len > len(src):
        raise CorruptError("huf stream truncated")
    if huf_decode is None:
        from h100_bench.reference.huf import huf_decompress
        huf_decode = huf_decompress
    blob = src[ip + 6: ip + 6 + comp_len]
    data = huf_decode(blob, orig_len)
    if len(data) != orig_len:
        raise CorruptError("huf stream decoded to wrong size")
    return _Stream(data, 0, orig_len), ip + 6 + comp_len


def decompress(src: bytes, max_out: int | None = None, huf_decode=None,
               out: bytearray | None = None, window_base: int | None = None,
               stop_at: int | None = None) -> bytes:
    """Decode a full Lizard compressed stream (the `Lizard_decompress_safe`
    container: 1 level byte + blocks). Returns the decompressed bytes.

    max_out, when given, bounds the output (corrupt streams producing more
    raise CorruptError). Pass `out` (existing decoded prefix) for
    linked-blocks streaming: matches may reach back into it
    (Lizard_decompress_safe_usingDict semantics, lizard_decompress.c:354-365).
    stop_at stops decoding once that many NEW bytes exist, possibly
    mid-token-loop (Lizard_decompress_safe_partial): remaining input is not
    parsed, so corruption past the target goes unreported, exactly like the
    reference's early return.
    """
    if len(src) < 1:
        raise CorruptError("empty input")
    prefix = len(out) if out is not None else 0
    if window_base is None:
        window_base = 0
    level = src[0]
    if level < LIZARD_MIN_CLEVEL or level > LIZARD_MAX_CLEVEL:
        raise CorruptError(f"bad level byte {level}")
    params = LEVELS[level]

    if out is None:
        out = bytearray()
    ip = 1
    iend = len(src)
    while ip < iend:
        header = src[ip]
        ip += 1
        if header == FLAG_UNCOMPRESSED:
            if ip > iend - 3:
                raise CorruptError("uncompressed block header truncated")
            n = _le24(src, ip)
            ip += 3
            if ip + n > iend:
                raise CorruptError("uncompressed block truncated")
            out += src[ip:ip + n]
            ip += n
            if stop_at is not None and len(out) - prefix >= stop_at:
                break
            if max_out is not None and len(out) - prefix > max_out:
                raise CorruptError("output exceeds max_out")
            continue
        if header & FLAG_LEN:
            raise CorruptError("FLAG_LEN set (reference rejects)")
        if header & ~(FLAG_LITERALS | FLAG_FLAGS | FLAG_OFFSET16 | FLAG_OFFSET24):
            raise CorruptError(f"bad header byte {header}")

        streams = {}
        streams["len"], ip = _read_stream(src, ip, 0, huf_decode)
        streams["off16"], ip = _read_stream(src, ip, header & FLAG_OFFSET16, huf_decode)
        streams["off24"], ip = _read_stream(src, ip, header & FLAG_OFFSET24, huf_decode)
        streams["flags"], ip = _read_stream(src, ip, header & FLAG_FLAGS, huf_decode)
        streams["literals"], ip = _read_stream(src, ip, header & FLAG_LITERALS, huf_decode)
        if ip > iend:
            raise CorruptError("streams exceed input")

        stop_abs = None if stop_at is None else prefix + stop_at
        if params.codewords == Codewords.LZ4:
            _decode_block_lz4(streams, out, window_base, stop_abs)
        else:
            _decode_block_liz(streams, out, window_base, stop_abs)

        if stop_at is not None and len(out) - prefix >= stop_at:
            break
        if max_out is not None and len(out) - prefix > max_out:
            raise CorruptError("output exceeds max_out")

    return bytes(out[prefix:])
