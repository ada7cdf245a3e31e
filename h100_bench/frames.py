"""The benchmark's frame writer, frozen from lizard_tpu_torch/frame.py
(`_descriptor`, `_frame_start`, `_block`, `_frame` and the block-size
choice of `_header`) at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea.
It writes the frames the frame-decode cells send, from blocks compressed
by the benchmark's frozen native encoder, so no change to the program's
encoder or frame writer changes them."""

from h100_bench import native
from h100_bench.reference.constants import (
    LIZARDF_BLOCK_SIZES, LIZARDF_BLOCKUNCOMPRESSED_FLAG, LIZARDF_MAGIC)


def _optimal_bsid(requested: int, src_size: int) -> int:
    """LizardF_optimalBSID (lizard_frame.c:203-218)."""
    proposed = 1
    while requested > proposed:
        if src_size <= LIZARDF_BLOCK_SIZES[proposed]:
            return proposed
        proposed += 1
    return requested


def _descriptor(block_size_id: int, content_checksum: bool) -> bytes:
    """FLG and BD of a blockIndependent frame with no content size."""
    flg = (1 << 6) | (1 << 5) | (int(content_checksum) << 2)
    return bytes([flg, (block_size_id & 7) << 4])


def _block(part: bytes, comp: bytes) -> bytes:
    """A frame block: `comp` with its size, or `part` stored when `comp`
    is not at least one byte shorter (lizard_frame.c:456-469)."""
    if len(comp) >= len(part):
        return (len(part) | LIZARDF_BLOCKUNCOMPRESSED_FLAG).to_bytes(
            4, "little") + part
    return len(comp).to_bytes(4, "little") + comp


def write_frame(data: bytes, level: int, block_size_id: int,
                content_checksum: bool = True) -> bytes:
    """A blockIndependent frame of `data`, each frame block compressed at
    `level` by the frozen native encoder."""
    bsid = _optimal_bsid(block_size_id, len(data))
    size = LIZARDF_BLOCK_SIZES[bsid]
    header = _descriptor(bsid, content_checksum)
    out = bytearray(LIZARDF_MAGIC.to_bytes(4, "little"))
    out += header
    out.append((native.xxh32(header) >> 8) & 0xFF)
    for pos in range(0, len(data), size):
        part = data[pos:pos + size]
        out += _block(part, native.compress(part, level))
    out += (0).to_bytes(4, "little")
    if content_checksum:
        out += native.xxh32(data).to_bytes(4, "little")
    return bytes(out)
