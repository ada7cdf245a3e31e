"""Lizard frame format: the one-shot encoders and the decoders (the port of
the matching parts of lizard_tpu/frame.py; doc/lizard_Frame_format.md,
lib/lizard_frame.c).

Container: magic, descriptor (FLG/BD/contentSize/HC), LE32-size-prefixed
blocks (high bit = stored), endmark, optional xxh32 content checksum.

`decompress_frame` / `decompress_one_frame` / `decompress_frames` decode
every frame the JAX package decodes, on the card: skippable frames,
blockIndependent frames (each compressed frame block one chain of the CUDA
LZ kernel, ops/lane_decode.py) and linked frames (the whole frame one
chain: stored frame blocks become literal-only inner blocks of it, so
matches reach across frame blocks through the chain's own output, the
reference's window_base=0), after the Huff0 kernel at levels 30-49
(ops/fuse.py); the frame blocks may mix codeword families.
`decompress_frame_lanes` is the JAX function of that name: blockIndependent
frames of one family only, walked and decoded as decompress_frame does
(_frame_blocks, decode_blocks). `compress_frame` is LizardF_compressFrame with
the oracle encoder (ref/block_encode.py), linked or independent blocks,
byte-equal to liblizard, serial on the host. `compress_frame_lanes`
compresses every frame block on the card with the device encoder
(ops/enc_lanes.py), Huff0 stage included (ops/enc_huf.py);
`compress_frame_tpu` is the JAX function of that name, its engine="xla"
the plain-PyTorch all-XLA encoder (ops/encode_tpu.py). Every decoder ends
with `frame_end` and `whole_frame`, the checks after the endmark.

`FrameEncoder` and `FrameDecoder` are the incremental layer
(LizardF_compressBegin/Update/Flush/End and LizardF_decompress): input of
any granularity in, bytes out as whole blocks complete, in bounded memory.
The encoder compresses an update's whole blocks in one batch on the card
(or with the native encoder or the oracle); the decoder decodes an update's
completed blocks of a frame in one batch on the card (decode_blocks), a
linked frame's chain headed by the 16 MB window it keeps.
"""

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    LIZARD_DICT_SIZE,
    LIZARDF_BLOCK_SIZES,
    LIZARDF_BLOCKUNCOMPRESSED_FLAG,
    LIZARDF_MAGIC,
    LIZARDF_MAGIC_SKIPPABLE_START,
)
from lizard_tpu_torch.format.levels import LEVELS, validate_level
from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.ops.enc_lanes import encode_streams_lanes
from lizard_tpu_torch.ops.encode_tpu import encode_streams_tpu
from lizard_tpu_torch.ops.fuse import decode_fused
from lizard_tpu_torch.ops.host_plan import split_plan
from lizard_tpu_torch.format.constants import LIZARD_BLOCK_SIZE
from lizard_tpu_torch.ops.split import inner_block_spans
from lizard_tpu_torch.ref import block_decode
from lizard_tpu_torch.ref.block_encode import DICT, Ctx, Tables, compress_range
from lizard_tpu_torch.runtime import XXH32, xxh32
from lizard_tpu_torch.utils import profiling


class FrameError(ValueError):
    pass


def _optimal_bsid(requested: int, src_size: int) -> int:
    """LizardF_optimalBSID (lizard_frame.c:203-218)."""
    proposed = 1
    while requested > proposed:
        if src_size <= LIZARDF_BLOCK_SIZES[proposed]:
            return proposed
        proposed += 1
    return requested


class FrameInfo:
    def __init__(self):
        self.block_size_id = 0
        self.block_linked = False
        self.content_checksum = False
        self.content_size = None
        self.header_size = 0


def parse_frame_header(src: bytes) -> FrameInfo:
    """LizardF_decodeHeader (lizard_frame.c:756-857)."""
    if len(src) < 7:
        raise FrameError("frame header truncated")
    magic = int.from_bytes(src[0:4], "little")
    if magic != LIZARDF_MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    flg = src[4]
    bd = src[5]
    if (flg >> 6) & 3 != 1:
        raise FrameError("unsupported frame version")
    if flg & 0b11 or bd & 0b10001111:
        raise FrameError("reserved bits set")
    if (flg >> 4) & 1:
        raise FrameError("block checksum unsupported")  # as in the reference
    info = FrameInfo()
    info.block_linked = ((flg >> 5) & 1) == 0
    info.content_checksum = bool((flg >> 2) & 1)
    has_size = bool((flg >> 3) & 1)
    bsid = (bd >> 4) & 7
    if bsid not in LIZARDF_BLOCK_SIZES:
        raise FrameError("bad blockSizeID")
    info.block_size_id = bsid
    p = 6
    if has_size:
        if len(src) < 15:
            raise FrameError("frame header truncated")
        info.content_size = int.from_bytes(src[6:14], "little")
        p = 14
    hc = src[p]
    if (xxh32(bytes(src[4:p])) >> 8) & 0xFF != hc:
        raise FrameError("header checksum mismatch")
    info.header_size = p + 1
    return info


def decoded_size_bound(src: bytes) -> int:
    """Tight upper bound on the decoded size of a (possibly concatenated)
    frame stream, from headers alone — contentSize when stored, otherwise
    block-count x maxBlockSize (sizing analogue of lizardio.c:647-698).
    Raises FrameError on malformed input."""
    bound = 0
    p = 0
    n = len(src)
    while p < n:
        magic = int.from_bytes(src[p:p + 4], "little") if p + 4 <= n else -1
        if (magic & 0xFFFFFFF0) == LIZARDF_MAGIC_SKIPPABLE_START:
            if p + 8 > n:
                raise FrameError("skippable frame truncated")
            p += 8 + int.from_bytes(src[p + 4:p + 8], "little")
            continue
        info = parse_frame_header(src[p:])
        p += info.header_size
        max_block = LIZARDF_BLOCK_SIZES[info.block_size_id]
        frame_bound = 0
        while True:
            if p + 4 > n:
                raise FrameError("missing endmark")
            bsize = int.from_bytes(src[p:p + 4], "little")
            p += 4
            if bsize == 0:
                break
            stored = bool(bsize & LIZARDF_BLOCKUNCOMPRESSED_FLAG)
            bsize &= ~LIZARDF_BLOCKUNCOMPRESSED_FLAG
            frame_bound += bsize if stored else max_block
            p += bsize
        if p > n:
            raise FrameError("block truncated")
        if info.content_checksum:
            p += 4
        bound += (info.content_size if info.content_size is not None
                  else frame_bound)
    return bound


def compress_frame_fast(data: bytes, level: int = 11,
                        block_size_id: int = 0,
                        content_checksum: bool = True,
                        content_size: bool = False) -> bytes:
    """Fast frame compression: blockIndependent frame, each block compressed
    by the native C++ encoder (valid streams for any level 10..49 including
    the Huff0 stage at >= 30; not byte-identical to the reference)."""
    level, block_size, header = _header(level, block_size_id, len(data),
                                        content_checksum, content_size)
    parts = [data[pos:pos + block_size]
             for pos in range(0, len(data), block_size)]
    return _frame(header, [runtime.compress(p, level) for p in parts],
                  parts, data, content_checksum)


def _descriptor(block_size_id, linked, content_checksum,
                content_size=None) -> bytes:
    """FLG, BD and, when content_size is an int, the content size: a frame
    header without its magic and its header checksum."""
    flg = (1 << 6) | ((0 if linked else 1) << 5) \
        | (int(content_checksum) << 2) | ((content_size is not None) << 3)
    header = bytearray([flg, (block_size_id & 7) << 4])
    if content_size is not None:
        header += content_size.to_bytes(8, "little")
    return bytes(header)


def _frame_start(header: bytes) -> bytearray:
    """The magic, the descriptor `header` and its header checksum byte."""
    out = bytearray(LIZARDF_MAGIC.to_bytes(4, "little"))
    out += header
    out.append((xxh32(header) >> 8) & 0xFF)
    return out


def _block(part: bytes, comp: bytes) -> bytes:
    """The frame block of `part` whose compressed stream is `comp`: its
    size and `comp`, or `part` stored when `comp` is not at least one byte
    shorter (LizardF_compressBlock, lizard_frame.c:456-469)."""
    if len(comp) >= len(part):
        return (len(part) | LIZARDF_BLOCKUNCOMPRESSED_FLAG).to_bytes(
            4, "little") + part
    return len(comp).to_bytes(4, "little") + comp


def _header(level, block_size_id, size, content_checksum, content_size,
            block_linked=False):
    """(level, block size, header bytes without the magic and the header
    checksum) of a frame: blockIndependent unless block_linked, which an
    input of one block at most turns off (lizard_frame.c:285-286)."""
    level = validate_level(level)
    if block_size_id == 0:
        block_size_id = 1  # LIZARDF_BLOCKSIZEID_DEFAULT (lizard_frame.c:120)
    block_size_id = _optimal_bsid(block_size_id, size)
    linked = block_linked and size > LIZARDF_BLOCK_SIZES[block_size_id]
    header = _descriptor(block_size_id, linked, content_checksum,
                         size if content_size else None)
    return level, LIZARDF_BLOCK_SIZES[block_size_id], header


def _frame(header, comps, parts, data, content_checksum) -> bytes:
    """The frame of the compressed blocks `comps` of `parts`: a block that
    does not shrink is stored."""
    out = _frame_start(header)
    for part, comp in zip(parts, comps):
        out += _block(part, comp)
    out += (0).to_bytes(4, "little")
    if content_checksum:
        with profiling.span("xxh32", "host"):
            out += xxh32(data).to_bytes(4, "little")
    return bytes(out)


def compress_frame(data: bytes, level: int = 17, block_size_id: int = 0,
                   block_linked: bool = False, content_checksum: bool = True,
                   content_size: bool = False) -> bytes:
    """LizardF_compressFrame (lizard_frame.c:260-310) with the oracle
    encoder (ref/block_encode.py), byte-equal to liblizard and to
    lizard_tpu/frame.py::compress_frame. One Tables is reused across frame
    blocks without clearing, which the bytes show. Independent blocks
    (Lizard_compress_extState) take a fresh Ctx and window each, with
    next_to_update reset; linked blocks (Lizard_compress_continue) are one
    Ctx over the whole input. A block compressed to more than its size
    less one byte is stored (LizardF_compressBlock, lizard_frame.c:456-469).
    Serial Python on the host."""
    level, block_size, header = _header(level, block_size_id, len(data),
                                        content_checksum, content_size,
                                        block_linked)
    linked = not header[0] & (1 << 5)   # as _header decided
    params = LEVELS[level]
    tables = Tables(params)
    ctx = Ctx(level, params)
    parts, comps = [], []
    for pos in range(0, len(data), block_size):
        part = data[pos:pos + block_size]
        if linked:
            comps.append(compress_range(ctx, tables, data, pos,
                                        pos + len(part)))
        else:
            ctx = Ctx(level, params)
            tables.next_to_update = DICT  # Lizard_init resets it
            comps.append(compress_range(ctx, tables, part, 0, len(part)))
        parts.append(part)
    return _frame(header, comps, parts, data, content_checksum)


@profiling.traced("compress_frame", "host")
def compress_frame_lanes(data: bytes, level: int = 11,
                         block_size_id: int = 0,
                         content_checksum: bool = True,
                         content_size: bool = False, device=None,
                         entropy: str = "gpu") -> bytes:
    """Frame compression with the device encoder on `device` (the card
    unless device="cpu"): a blockIndependent frame whose blocks' 128 KB
    chunks are compressed in one batch (ops/enc_lanes.py::
    encode_streams_lanes), levels 10-49; at 30-49 the Huff0 stage runs on
    `device` (entropy="gpu", the default) or in the native Huff0 on the host
    (entropy="host"). The counterpart of lizard_tpu/frame.py::
    compress_frame_tpu with engine="lanes"."""
    level, block_size, header = _header(level, block_size_id, len(data),
                                        content_checksum, content_size)
    parts = [data[pos:pos + block_size]
             for pos in range(0, len(data), block_size)]
    comps = encode_streams_lanes(parts, level=level, device=device,
                                 entropy=entropy)
    return _frame(header, comps, parts, data, content_checksum)


def compress_frame_tpu(data: bytes, level: int = 11,
                       block_size_id: int = 0,
                       content_checksum: bool = True,
                       content_size: bool = False, engine: str | None = None,
                       device=None) -> bytes:
    """Frame compression on `device` (the card unless device="cpu"): a
    blockIndependent frame whose blocks' 128 KB chunks are compressed in one
    batch. The port of lizard_tpu/frame.py::compress_frame_tpu:
    engine="lanes" (the default) is encode_streams_lanes, the device
    encoder of ops/enc_lanes.py, levels 10-49 (compress_frame_lanes with
    entropy="gpu"); engine="xla" is ops/encode_tpu.py::encode_streams_tpu,
    the plain-PyTorch port of the JAX package's all-XLA pipeline, fastLZ4
    levels 10-19 only. (The JAX default picks "xla" on its CPU backend for
    levels below 20; the port's lanes engine runs on the CPU too, as its
    plain versions, so its default is "lanes" everywhere.)"""
    engine = engine or "lanes"
    if engine not in ("lanes", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    level, block_size, header = _header(level, block_size_id, len(data),
                                        content_checksum, content_size)
    if engine == "xla" and level >= 20:
        raise ValueError("engine='xla' supports levels 10-19 only")
    parts = [data[pos:pos + block_size]
             for pos in range(0, len(data), block_size)]
    encode = encode_streams_lanes if engine == "lanes" else encode_streams_tpu
    return _frame(header, encode(parts, level=level, device=device), parts,
                  data, content_checksum)


def linked_frame(stream: bytes, data: bytes, block_size_id: int = 4) -> bytes:
    """A linked frame of the compressed stream `stream` of `data`, without
    encoding anew: the stream's inner blocks (at most LIZARD_BLOCK_SIZE
    bytes each) cut into frame blocks of LIZARDF_BLOCK_SIZES[block_size_id]
    bytes of output at most, each its level byte and its inner blocks, and
    a content checksum. Later frame blocks' matches reach into earlier ones,
    as the stream's did."""
    per = LIZARDF_BLOCK_SIZES[block_size_id] // LIZARD_BLOCK_SIZE
    spans = inner_block_spans(stream)
    out = _frame_start(_descriptor(block_size_id, True, True))
    for k in range(0, len(spans), per):
        last = spans[min(k + per, len(spans)) - 1]
        part = stream[0:1] + stream[spans[k][0]:last[1]]
        out += len(part).to_bytes(4, "little") + part
    out += (0).to_bytes(4, "little") + xxh32(data).to_bytes(4, "little")
    return bytes(out)


def decompress_frame_lanes(src: bytes, device=None) -> bytes:
    """Decode one blockIndependent frame of one codeword family on `device`
    (the card unless device="cpu"), as decompress_frame does: every frame
    block one chain of the LZ kernel, after the Huff0 kernel at levels
    30-49. The JAX function of this name takes no other frame, so a linked
    frame, a block whose level byte is not a level, and blocks of two
    codeword families raise FrameError, as does any malformed frame or
    block."""
    dev = resolve_device(device)
    info = parse_frame_header(src)
    if info.block_linked:
        raise FrameError("lane path requires blockIndependent frames")
    blocks, p = _frame_blocks(src, info.header_size)
    families = set()
    for stored, blob in blocks:
        if stored:
            continue
        level = blob[0] if blob else 0
        if level not in LEVELS:
            raise FrameError("bad level byte")
        families.add(LEVELS[level].codewords)
    if len(families) > 1:
        raise FrameError("mixed codeword families")
    out = _decode_frame_blocks(blocks, False,
                               LIZARDF_BLOCK_SIZES[info.block_size_id], dev)
    whole_frame(src, frame_end(src, p, info, out))
    return out


def frame_end(src: bytes, p: int, info: FrameInfo, out: bytes,
              verify_checksum: bool = True) -> int:
    """The checks after a frame's endmark at `p`, of every frame decoder:
    the content checksum (present, and equal to `out`'s when
    verify_checksum) and the header's content size against `out`. Returns
    the position after the frame."""
    if info.content_checksum:
        if p + 4 > len(src):
            raise FrameError("missing content checksum")
        stored_crc = int.from_bytes(src[p:p + 4], "little")
        p += 4
        if verify_checksum:
            with profiling.span("xxh32", "host"):
                crc = xxh32(out)
            if crc != stored_crc:
                raise FrameError("content checksum mismatch")
    if info.content_size is not None and info.content_size != len(out):
        raise FrameError("content size mismatch")
    return p


def whole_frame(src: bytes, end: int) -> None:
    """Refuse any byte after a frame that ends at `end`, a second frame
    included."""
    if end != len(src):
        raise FrameError("trailing data after frame")


def _frame_blocks(src: bytes, p: int) -> tuple[list[tuple[bool, bytes]], int]:
    """The (stored, payload) frame blocks from p to the endmark, and the
    position after it."""
    blocks = []
    while True:
        if p + 4 > len(src):
            raise FrameError("missing endmark")
        bsize = int.from_bytes(src[p:p + 4], "little")
        p += 4
        if bsize == 0:
            return blocks, p
        stored = bool(bsize & LIZARDF_BLOCKUNCOMPRESSED_FLAG)
        bsize &= ~LIZARDF_BLOCKUNCOMPRESSED_FLAG
        if p + bsize > len(src):
            raise FrameError("block truncated")
        blocks.append((stored, src[p:p + bsize]))
        p += bsize


def decode_blocks(blocks, linked: bool, dev, max_out: int | None = None,
                  history: bytes = b"") -> list[bytes]:
    """The decoded bytes of each (stored, payload) frame block, all in one
    batch on `dev`: a linked frame is one chain (stream id 0; a stored
    block is literal-only inner blocks of it), else each frame block is
    its own chain. A linked chain may be headed by `history`, the bytes
    decoded before these blocks, which their matches may reach: it is
    staged as literal-only inner blocks (split.split_stored) and not copied
    back. The host split and Huff0 plan is one native pass (ops/
    host_plan.py::split_plan); then one lz_decode launch, after one
    huf_decode launch at levels 30-49. Raises CorruptError for a corrupt
    block, or one whose output exceeds max_out."""
    if history and not linked:
        raise ValueError("a history heads a linked chain only")
    head = [(True, history)] if history else []
    items = head + list(blocks)
    sids = [0 if linked else i for i in range(len(items))]
    skip = -(-len(history) // LIZARD_BLOCK_SIZE)    # the history's blocks
    batch, plan, ends = split_plan([blob for _, blob in items], sids,
                                   [stored for stored, _ in items],
                                   check_family=False)
    decoded = decode_fused(batch, plan, dev, first=skip)
    with profiling.span("answer", "host"):
        parts = []
        for (stored, _), first, end in list(zip(items, [0] + ends,
                                                ends))[len(head):]:
            part = b"".join(decoded[first - skip:end - skip])
            if not stored and max_out is not None and len(part) > max_out:
                raise CorruptError("output exceeds max_out")
            parts.append(part)
        return parts


def _decode_frame_blocks(blocks, linked: bool, max_block: int,
                         dev) -> bytes:
    """Every frame block of a frame in one batch (decode_blocks), joined;
    a corrupt block raises FrameError."""
    try:
        parts = decode_blocks(blocks, linked, dev, max_block)
    except CorruptError as e:
        raise FrameError(f"block decode failed: {e}") from e
    with profiling.span("answer", "host"):
        return b"".join(parts)


def decompress_one_frame(src: bytes, verify_checksum: bool = True,
                         device=None) -> tuple[bytes, int]:
    """Decode the frame at the start of `src` on `device` (the card unless
    device="cpu"): (its bytes, the bytes it took). A skippable frame gives
    b"". Linked and blockIndependent frames, any level, families mixed
    (see the module note). The port of lizard_tpu/frame.py::
    decompress_one_frame; raises FrameError."""
    if len(src) >= 8:
        magic = int.from_bytes(src[0:4], "little")
        if (magic & 0xFFFFFFF0) == LIZARDF_MAGIC_SKIPPABLE_START:
            size = int.from_bytes(src[4:8], "little")
            if 8 + size > len(src):
                raise FrameError("skippable frame truncated")
            return b"", 8 + size
    dev = resolve_device(device)
    with profiling.span("frame_parse", "host"):
        info = parse_frame_header(src)
        blocks, p = _frame_blocks(src, info.header_size)
    out = _decode_frame_blocks(blocks, info.block_linked,
                               LIZARDF_BLOCK_SIZES[info.block_size_id], dev)
    return out, frame_end(src, p, info, out, verify_checksum)


@profiling.traced("decompress_frame", "host")
def decompress_frame(src: bytes, verify_checksum: bool = True,
                     device=None) -> bytes:
    """Decode one frame (decompress_one_frame); raises FrameError on any
    byte after it, a second frame included (decompress_frames takes
    those)."""
    out, consumed = decompress_one_frame(src, verify_checksum, device)
    whole_frame(src, consumed)
    return out


def decompress_frames(src: bytes, verify_checksum: bool = True,
                      device=None) -> bytes:
    """Decode a sequence of concatenated frames, skippable ones included."""
    out = bytearray()
    p = 0
    while p < len(src):
        data, n = decompress_one_frame(src[p:], verify_checksum, device)
        out += data
        p += n
    return bytes(out)


class FrameEncoder:
    """Incremental frame compression: LizardF_compressBegin / Update /
    Flush / End (lizard_frame.c:501-629), the port of
    lizard_tpu/frame.py::FrameEncoder with its state machine and messages.
    Input of any granularity buffers (the reference's tmpIn) until a whole
    frame block accumulates or flush() forces a partial one out; memory
    stays O(window + block).

    backend="gpu" (the default, as in api.compress_frame): every whole block
    an update() completes is compressed in one encode_streams_lanes call on
    `device` (the card unless device="cpu"), so the
    frame equals compress_frame_lanes' with the same level, block size,
    checksum and content size; blockIndependent only (block_linked=True
    raises ValueError). backend="native" (the C++ encoder, a block a call)
    and backend="ref" (the oracle) are the JAX ones, byte for byte: linked
    frames go through streaming.CompressStream, and independent ref frames
    equal compress_frame's with the same prefs."""

    def __init__(self, level: int = 17, block_size_id: int = 0,
                 block_linked: bool = False, content_checksum: bool = True,
                 content_size: int | None = None, backend: str = "gpu",
                 device=None):
        if backend not in ("gpu", "native", "ref"):
            raise ValueError(
                f"backend {backend!r}: use 'gpu', 'native' or 'ref'")
        if backend == "gpu" and block_linked:
            raise ValueError("backend='gpu' makes independent blocks only; "
                             "block_linked=True needs backend='ref' or "
                             "'native'")
        self.level = validate_level(level)
        self.params = LEVELS[self.level]
        if block_size_id == 0:
            block_size_id = 1  # LIZARDF_BLOCKSIZEID_DEFAULT
        self.block_size_id = block_size_id
        self.block_size = LIZARDF_BLOCK_SIZES[block_size_id]
        self.block_linked = block_linked
        self.content_checksum = content_checksum
        self.content_size = content_size
        self.backend = backend
        self.device = resolve_device(device) if backend == "gpu" else None
        self.tmp = bytearray()      # partial-block buffer (tmpIn)
        self.total_in = 0
        self.xxh = XXH32(0) if content_checksum else None
        self._begun = False
        self._ended = False
        if block_linked:
            # streaming builds on this module, so it is imported here
            from lizard_tpu_torch.streaming import CompressStream
            self._cs = CompressStream(self.level)
        else:
            self._tables = Tables(self.params)

    def begin(self) -> bytes:
        """Frame header bytes (LizardF_compressBegin)."""
        assert not self._begun
        self._begun = True
        return bytes(_frame_start(_descriptor(
            self.block_size_id, self.block_linked, self.content_checksum,
            self.content_size)))

    def _compress(self, part: bytes) -> bytes:
        """One block's compressed stream on the host backends."""
        if self.block_linked:
            return self._cs.compress_continue(part)
        if self.backend == "native":
            return runtime.compress(part, self.level)
        # extState per block: fresh ctx/window, tables NOT cleared
        ctx = Ctx(self.level, self.params)
        self._tables.next_to_update = DICT  # Lizard_init
        return compress_range(ctx, self._tables, part, 0, len(part))

    def _emit_blocks(self, parts: list[bytes]) -> bytes:
        if self.backend == "gpu":
            comps = encode_streams_lanes(parts, level=self.level,
                                         device=self.device)
        else:
            comps = [self._compress(p) for p in parts]
        return b"".join(_block(p, c) for p, c in zip(parts, comps))

    def update(self, chunk: bytes) -> bytes:
        """Feed input; returns any compressed bytes produced
        (LizardF_compressUpdate: only whole blocks are emitted)."""
        if not self._begun or self._ended:
            raise FrameError("update outside begin/end")
        self.total_in += len(chunk)
        if self.xxh is not None:
            self.xxh.update(chunk)
        self.tmp += chunk
        whole = len(self.tmp) - len(self.tmp) % self.block_size
        if not whole:
            return b""
        parts = [bytes(self.tmp[i:i + self.block_size])
                 for i in range(0, whole, self.block_size)]
        del self.tmp[:whole]
        return self._emit_blocks(parts)

    def flush(self) -> bytes:
        """Force the buffered partial block out (LizardF_flush)."""
        if not self.tmp:
            return b""
        part = bytes(self.tmp)
        self.tmp.clear()
        return self._emit_blocks([part])

    def end(self) -> bytes:
        """Flush + endmark + optional content checksum (LizardF_compressEnd).
        Raises FrameError if a declared content_size was not matched."""
        if self._ended:
            raise FrameError("end called twice")
        out = bytearray(self.flush())
        self._ended = True
        if (self.content_size is not None
                and self.total_in != self.content_size):
            raise FrameError(
                f"content size mismatch: declared {self.content_size}, "
                f"got {self.total_in}")
        out += (0).to_bytes(4, "little")
        if self.content_checksum:
            out += self.xxh.digest().to_bytes(4, "little")
        return bytes(out)


class FrameDecoder:
    """Incremental frame decoder: accepts input chunks of any size and
    returns output as it becomes available, like LizardF_decompress's
    resumable dStage machine (lizard_frame.c:713-722,980-1319); the port of
    lizard_tpu/frame.py::FrameDecoder, with its state machine, its fields
    (buf, out, emitted, trimmed, finished, info) and its messages, and the
    same bytes from each update().

    backend="gpu" (the default) decodes on `device` (the card unless
    device="cpu"): the blocks of one
    frame that an update() completes are decoded together when the update
    ends or the frame does (decode_blocks): one lz_decode call, after at
    most one huf_decode call at levels 30-49, and none when no compressed
    block completed. A linked frame's chain is headed by the window kept in
    `out` (the frame's output from max(its start, the end less
    LIZARD_DICT_SIZE)), staged as a stored block; `restaged` lists the
    history bytes staged for each such call (0 for an independent frame).
    backend="ref" decodes each block with the oracle as it completes, as
    the JAX one does. A corrupt block raises CorruptError; the checksum and
    the content size FrameError."""

    def __init__(self, verify_checksum: bool = True, device=None,
                 backend: str = "gpu"):
        if backend not in ("gpu", "ref"):
            raise ValueError(f"backend {backend!r}: use 'gpu' or 'ref'")
        self.buf = bytearray()
        self.out = bytearray()
        self.emitted = 0          # index into self.out
        self.trimmed = 0          # bytes dropped from the front of self.out
        self.verify = verify_checksum
        self.state = "header"
        self.info = None
        self.xxh = XXH32(0)
        self.skip_left = 0
        self.finished = False
        self._frame_produced = 0
        self.backend = backend
        self.device = resolve_device(device) if backend == "gpu" else None
        self._pending = []        # this frame's blocks not decoded yet
        self.restaged = []

    def update(self, chunk: bytes) -> bytes:
        """Feed a chunk; returns newly decoded bytes. Memory stays bounded
        for arbitrarily long frames (lizardio.c:647-698's 64 KB loop relies
        on this): emitted output is dropped, keeping only the linked-mode
        window (<= LIZARD_DICT_SIZE) when one is needed."""
        self.buf += chunk
        progress = True
        while progress:
            progress = self._step()
        self._decode_pending()
        new = bytes(self.out[self.emitted:])
        self.emitted = len(self.out)
        self._trim()
        return new

    def _trim(self) -> None:
        logical_len = self.trimmed + len(self.out)
        if (self.info is not None and self.info.block_linked
                and not self.finished):
            keep_from = max(self._frame_out_start,
                            logical_len - LIZARD_DICT_SIZE)
        else:
            keep_from = logical_len
        cut = min(keep_from, self.trimmed + self.emitted)
        drop = cut - self.trimmed
        if drop > 0:
            del self.out[:drop]
            self.trimmed = cut
            self.emitted -= drop

    def _produced(self, part) -> None:
        self._frame_produced += len(part)
        if self.info.content_checksum:
            self.xxh.update(part)

    def _decode_pending(self) -> None:
        """Decode the frame blocks gathered since the last call, in order,
        onto `out`."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        linked = self.info.block_linked
        max_block = LIZARDF_BLOCK_SIZES[self.info.block_size_id]
        frame_base = max(self._frame_out_start - self.trimmed, 0)
        if self.backend == "ref":
            for stored, blob in pending:
                prefix = len(self.out)
                if stored:
                    self.out += blob
                else:
                    block_decode.decompress(
                        blob, max_out=max_block, out=self.out,
                        window_base=frame_base if linked else prefix)
                self._produced(self.out[prefix:])
            return
        if all(stored for stored, _ in pending):
            parts = [blob for _, blob in pending]
        else:
            history = b""
            if linked:
                keep = max(frame_base, len(self.out) - LIZARD_DICT_SIZE)
                history = bytes(self.out[keep:])
            parts = decode_blocks(pending, linked, self.device,
                                  max_out=max_block, history=history)
            self.restaged.append(len(history))
        for part in parts:
            self.out += part
            self._produced(part)

    def _step(self) -> bool:
        buf = self.buf
        if self.state == "header":
            if len(buf) < 4:
                return False
            magic = int.from_bytes(buf[0:4], "little")
            if (magic & 0xFFFFFFF0) == LIZARDF_MAGIC_SKIPPABLE_START:
                if len(buf) < 8:
                    return False
                self.finished = False  # a new frame begins
                self.skip_left = int.from_bytes(buf[4:8], "little")
                del buf[:8]
                self.state = "skip"
                return True
            # need full descriptor; max 15 bytes
            if len(buf) < 7:
                return False
            has_size = bool((buf[4] >> 3) & 1)
            need = 15 if has_size else 7
            if len(buf) < need:
                return False
            self.info = parse_frame_header(bytes(buf[:need]))
            self.finished = False  # a new frame begins
            del buf[:self.info.header_size]
            self.xxh = XXH32(0)
            self._frame_out_start = self.trimmed + len(self.out)
            self._frame_produced = 0
            self.state = "blocksize"
            return True
        if self.state == "skip":
            n = min(self.skip_left, len(buf))
            del buf[:n]
            self.skip_left -= n
            if self.skip_left == 0:
                self.state = "header"
                self.finished = True
                return True
            return False
        if self.state == "blocksize":
            if len(buf) < 4:
                return False
            bsize = int.from_bytes(buf[0:4], "little")
            if bsize == 0:
                del buf[:4]
                self._decode_pending()       # the frame closes its batch
                self.state = "suffix" if self.info.content_checksum else "header"
                if self.state == "header":
                    self._check_content_size()
                    self.finished = True
                return True
            self._bsize = bsize & ~LIZARDF_BLOCKUNCOMPRESSED_FLAG
            self._stored = bool(bsize & LIZARDF_BLOCKUNCOMPRESSED_FLAG)
            del buf[:4]
            self.state = "block"
            return True
        if self.state == "block":
            if len(buf) < self._bsize:
                return False
            self._pending.append((self._stored, bytes(buf[:self._bsize])))
            del buf[:self._bsize]
            if self.backend == "ref":
                self._decode_pending()
            self.state = "blocksize"
            return True
        if self.state == "suffix":
            if len(buf) < 4:
                return False
            stored_crc = int.from_bytes(buf[0:4], "little")
            del buf[:4]
            if self.verify and self.xxh.digest() != stored_crc:
                raise FrameError("content checksum mismatch")
            self._check_content_size()
            self.state = "header"
            self.finished = True
            return True
        return False

    def _check_content_size(self):
        if self.info and self.info.content_size is not None:
            if self._frame_produced != self.info.content_size:
                raise FrameError("content size mismatch")
