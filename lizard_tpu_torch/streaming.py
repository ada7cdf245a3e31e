"""Streaming (multi-call) compression and decompression, the equivalents of
Lizard_createStream/Lizard_compress_continue/Lizard_saveDict/
Lizard_setExternalDict and Lizard_setStreamDecode/
Lizard_decompress_safe_continue/_usingDict/_partial
(lib/lizard_compress.h:150-198, lib/lizard_compress.c:440-580,
lib/lizard_decompress.h:95-145, lib/lizard_decompress.c:278-371): the port
of lizard_tpu/streaming.py.

- CompressStream is the oracle's streaming encoder (ref/block_encode.py),
  serial Python on the host as in the JAX package, and its streams are
  byte-equal to the JAX ones: the stream keeps one logical window buffer,
  [retained dict tail | new data], trimmed and REBASED whenever it exceeds
  twice the window (every match-finder table entry less the trimmed byte
  count; entries that fall below the base become < DICT, which every
  parser rejects). Memory stays <= 2 windows + a chunk. There is no device
  encoder whose window carries across calls, so no device is involved.

- The decoders run on `device` (the card unless device="cpu"). Each call
  decodes its stream as one chain of the LZ kernel headed by the retained
  history (DecompressStream) or the dictionary, staged as literal-only
  inner blocks (frame.decode_blocks), and copies back only the new bytes.
  An offset that reaches before the history raises CorruptError, as in the
  oracle. `max_history` bounds the history as in the JAX package (the
  ring-buffer rules of lib/lizard_decompress.h:118-134 hold: matches only
  address the last windowLog bytes); at most LIZARD_DICT_SIZE bytes of it,
  all that an offset reaches, are staged.

- decompress_partial stops early at the inner-block level: it reads the
  inner-block headers one at a time and decodes only the blocks that reach
  the target, so the input past them is never parsed. The oracle stops
  inside the token loop instead; so corruption inside the block that
  reaches the target, past the target, raises here and not there (a
  difference on purpose: the kernel has no stop point).
"""

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    LIZARD_BLOCK_SIZE, LIZARD_DICT_SIZE)
from lizard_tpu_torch.format.levels import LEVELS, Parser, validate_level
from lizard_tpu_torch.frame import decode_blocks
from lizard_tpu_torch.ops.split import inner_block_end
from lizard_tpu_torch.ref.block_encode import (
    DICT, Ctx, Tables, _read64, compress_range, hash5)


class CompressStream:
    """Lizard_createStream + Lizard_compress_continue equivalent with
    bounded memory (Lizard_saveDict's actual job)."""

    def __init__(self, level: int = 17, dict_data: bytes = b""):
        self.level = validate_level(level)
        self.params = LEVELS[self.level]
        self.ctx = Ctx(self.level, self.params)
        self.tables = Tables(self.params)
        window = min(1 << self.params.window_log, LIZARD_DICT_SIZE)
        self.window = window
        self.buf = bytearray(dict_data[-window:])
        self._warm_tables()

    # -- internals ---------------------------------------------------------

    def _warm_tables(self):
        """Make a pre-loaded dictionary visible to the match finders
        (Lizard_loadDict, lizard_compress.c:393-414). Chain-family parsers
        self-insert history from next_to_update (= position 0) on the first
        compress call; the hash-probing fast parsers never revisit old
        positions, so their heads are inserted here."""
        if self.params.parser not in (Parser.FAST, Parser.FAST_SMALL):
            return
        htab = self.tables.hash
        hlog = self.params.hash_log
        for i in range(max(len(self.buf) - 8, 0)):
            htab[hash5(_read64(self.buf, i), hlog)] = i + DICT

    def _rebase(self, delta: int) -> None:
        """Drop `delta` leading bytes of the logical buffer and shift every
        table index down (Lizard_saveDict memmove + rebase,
        lizard_compress.c:550-580; also the 2 GB wrap rebase at :440-470)."""
        if delta <= 0:
            return
        del self.buf[:delta]
        t = self.tables
        t.hash = [max(i - delta, 0) for i in t.hash]
        if t.hash3 is not None:
            t.hash3 = [max(i - delta, 0) for i in t.hash3]
        if t.chain is not None:
            t.chain = [max(i - delta, 0) for i in t.chain]
        t.next_to_update = max(t.next_to_update - delta, DICT)

    # -- API ---------------------------------------------------------------

    def compress_continue(self, chunk: bytes) -> bytes:
        """Compress `chunk` with the window covering all previous chunks
        (bounded by windowLog). Returns one compressed stream."""
        start = len(self.buf)
        self.buf += chunk
        out = compress_range(self.ctx, self.tables, self.buf, start,
                             len(self.buf))
        if len(self.buf) > 2 * self.window:
            self._rebase(len(self.buf) - self.window)
        return out

    def save_dict(self, max_size: int = LIZARD_DICT_SIZE) -> bytes:
        """Retain only the last min(max_size, window) bytes as dictionary
        and rebase the state onto them (Lizard_saveDict). Returns the
        retained bytes; subsequent compress_continue calls use them as the
        window."""
        keep = min(max_size, self.window, len(self.buf))
        self._rebase(len(self.buf) - keep)
        return bytes(self.buf)

    def set_external_dict(self, dict_data: bytes) -> None:
        """Lizard_setExternalDict: replace the window with an external
        buffer. Table history is discarded (entries point into the old
        window); the new dict becomes match-reachable immediately."""
        keep = dict_data[-self.window:]
        self.buf = bytearray(keep)
        t = self.tables
        t.hash = [0] * len(t.hash)
        if t.hash3 is not None:
            t.hash3 = [0] * len(t.hash3)
        if t.chain is not None:
            t.chain = [0] * len(t.chain)
        t.next_to_update = DICT
        self._warm_tables()


def _decode(src: bytes, history: bytes, max_out, dev) -> bytes:
    """The bytes of the stream `src` decoded as one chain headed by
    `history` (its last LIZARD_DICT_SIZE bytes: no offset reaches further)
    on `dev`; only the new bytes come back. Raises CorruptError, also when
    they exceed max_out (None: no bound)."""
    return decode_blocks([(False, src)], True, dev, max_out=max_out,
                         history=bytes(history[-LIZARD_DICT_SIZE:]))[0]


class DecompressStream:
    """Lizard_setStreamDecode + Lizard_decompress_safe_continue equivalent:
    decodes a sequence of compressed streams whose windows chain, on
    `device` (the card unless device="cpu"). Handles the prefix,
    external-dictionary and ring-buffer usage patterns with one bounded
    `history` buffer (see the module note)."""

    def __init__(self, dict_data: bytes = b"",
                 max_history: int = LIZARD_DICT_SIZE, device=None):
        self.max_history = max_history
        self.history = bytearray(dict_data[-max_history:])
        self.device = resolve_device(device)

    def decompress_continue(self, src: bytes, max_out: int) -> bytes:
        new = _decode(src, self.history, max_out, self.device)
        self.history += new
        if len(self.history) > self.max_history:
            del self.history[:len(self.history) - self.max_history]
        return new


def decompress_partial(src: bytes, target: int, max_out: int,
                       dict_data: bytes = b"", device=None) -> bytes:
    """Lizard_decompress_safe_partial on `device`: decode at least `target`
    bytes then stop. The inner-block headers are read one at a time; the
    first ceil(min(target, max_out) / LIZARD_BLOCK_SIZE) inner blocks are
    decoded (headed by `dict_data`), and more only while the bytes fall
    short; no block past the one that reaches the target is parsed.
    Returns min(target, max_out, decoded) bytes."""
    if target <= 0:
        return b""
    if len(src) < 1:
        raise CorruptError("empty input")
    if src[0] not in LEVELS:
        raise CorruptError(f"bad level byte {src[0]}")
    dev = resolve_device(device)
    stop = min(target, max_out)
    got = bytearray()
    ip = 1
    while len(got) < stop and ip < len(src):
        start = ip
        for _ in range(-(-(stop - len(got)) // LIZARD_BLOCK_SIZE)):
            if ip >= len(src):
                break
            ip = inner_block_end(src, ip)
        got += _decode(src[:1] + src[start:ip],
                       bytes(dict_data[-LIZARD_DICT_SIZE:]) + got, None, dev)
    return bytes(got[:stop])


def decompress_using_dict(src: bytes, max_out: int, dict_data: bytes,
                          device=None) -> bytes:
    """Lizard_decompress_safe_usingDict: one-shot decode with an external
    dictionary (covers the prefix and extDict modes,
    lizard_decompress.c:354-371), on `device` (the card unless
    device="cpu")."""
    return _decode(src, dict_data, max_out, resolve_device(device))
