"""The plain reference's frame reader: the container parse of
lizard_tpu_torch/frame.py (`parse_frame_header`, `_frame_blocks`,
`frame_end`, `whole_frame`) at commit
0be7bf655f3d0745fc3f06a33be719434c2ddeea, over the serial block decoder of
this folder. The caller passes the xxh32 to use (the checksums are the
container's, not the codec's), so this folder imports nothing outside
itself."""

from h100_bench.reference import block_decode
from h100_bench.reference.constants import (
    LIZARDF_BLOCK_SIZES, LIZARDF_BLOCKUNCOMPRESSED_FLAG, LIZARDF_MAGIC)


class FrameError(ValueError):
    pass


def parse(src: bytes, xxh32) -> dict:
    """The container of one frame: its descriptor's fields, its blocks as
    (stored, payload), and its content checksum (None when absent).
    Raises FrameError on any departure from the format, a byte after the
    frame included."""
    if len(src) < 7:
        raise FrameError("frame header truncated")
    if int.from_bytes(src[0:4], "little") != LIZARDF_MAGIC:
        raise FrameError("bad magic")
    flg, bd = src[4], src[5]
    if (flg >> 6) & 3 != 1:
        raise FrameError("unsupported frame version")
    if flg & 0b11 or bd & 0b10001111:
        raise FrameError("reserved bits set")
    if (flg >> 4) & 1:
        raise FrameError("block checksum unsupported")
    bsid = (bd >> 4) & 7
    if bsid not in LIZARDF_BLOCK_SIZES:
        raise FrameError("bad blockSizeID")
    p, content_size = 6, None
    if (flg >> 3) & 1:
        if len(src) < 15:
            raise FrameError("frame header truncated")
        content_size = int.from_bytes(src[6:14], "little")
        p = 14
    if (xxh32(bytes(src[4:p])) >> 8) & 0xFF != src[p]:
        raise FrameError("header checksum mismatch")
    p += 1
    blocks = []
    while True:
        if p + 4 > len(src):
            raise FrameError("missing endmark")
        bsize = int.from_bytes(src[p:p + 4], "little")
        p += 4
        if bsize == 0:
            break
        stored = bool(bsize & LIZARDF_BLOCKUNCOMPRESSED_FLAG)
        bsize &= ~LIZARDF_BLOCKUNCOMPRESSED_FLAG
        if p + bsize > len(src):
            raise FrameError("block truncated")
        blocks.append((stored, bytes(src[p:p + bsize])))
        p += bsize
    checksum = None
    if (flg >> 2) & 1:
        if p + 4 > len(src):
            raise FrameError("missing content checksum")
        checksum = int.from_bytes(src[p:p + 4], "little")
        p += 4
    if p != len(src):
        raise FrameError("trailing data after frame")
    return {"block_size": LIZARDF_BLOCK_SIZES[bsid],
            "linked": not (flg >> 5) & 1, "checksum": checksum,
            "content_size": content_size, "blocks": blocks}


def decode_block(block: tuple[bool, bytes], max_out: int) -> bytes:
    """One frame block of a blockIndependent frame, by the serial
    reference decoder."""
    stored, payload = block
    if stored:
        return payload
    return block_decode.decompress(payload, max_out)


def decode(src: bytes, xxh32) -> bytes:
    """The content of one frame, by the serial reference decoder, its
    content checksum and size checked."""
    f = parse(src, xxh32)
    out = bytearray()
    for stored, payload in f["blocks"]:
        if stored:
            out += payload
        elif f["linked"]:
            block_decode.decompress(payload, f["block_size"], out=out)
        else:
            out += block_decode.decompress(payload, f["block_size"])
    out = bytes(out)
    if f["checksum"] is not None and xxh32(out) != f["checksum"]:
        raise FrameError("content checksum mismatch")
    if f["content_size"] is not None and f["content_size"] != len(out):
        raise FrameError("content size mismatch")
    return out
