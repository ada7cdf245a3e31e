"""The control and the planted faults of the correctness check, each put in
the program's place for a request form (see harness.py): the check must
find every one of them. The benchmark's own runs use none of these;
control.py runs them on the card at a cell's size, and tests/ at a small
size on the CPU.

- control: the lossless guarantee broken the way a tempting shortcut
  would. Decode forms: the plain reference in the program's place with
  every match copied as one block from the output as it stood (a
  vectorised copy that ignores a match overlapping its own output, offset
  < length, so the bytes it has not written yet read as zeros). The encode form: the
  program's frames with the content checksum that the configuration
  promises left out (the xxh32 pass over the input skipped).
- altered: one byte of an answer flipped where it is produced.
- half: half of the request's batch left out (the first half of the
  streams decoded, half of a frame's content returned, half of an input
  compressed).
- stale: every call after the first returns the first call's answer, a
  step that leaves its state unchanged.
"""

import contextlib

from h100_bench import native
from h100_bench.reference import block_decode
from h100_bench.reference import frame as ref_frame


def _block_copy(out: bytearray, offset: int, length: int) -> None:
    """A match copied as it stood before the copy: where it overlaps its
    own output, the bytes not yet written read as zeros."""
    start = len(out) - offset
    src = out[start:start + length]
    out += src + bytes(length - len(src))


@contextlib.contextmanager
def _shortcut():
    saved = block_decode._copy_match
    block_decode._copy_match = _block_copy
    try:
        yield
    finally:
        block_decode._copy_match = saved


def _frame_content(src: bytes) -> bytes:
    """A blockIndependent frame's blocks decoded by the reference, with no
    checksum verified."""
    f = ref_frame.parse(src, native.xxh32)
    return b"".join(ref_frame.decode_block(b, f["block_size"])
                    for b in f["blocks"])


def control(fn, form: str):
    if form == "streams":
        def call(streams, **kw):
            with _shortcut():
                return [block_decode.decompress(s) for s in streams]
    elif form == "frame":
        def call(frame, **kw):
            with _shortcut():
                return _frame_content(frame)
    elif form == "raw":
        def call(data, **kw):
            f = bytearray(fn(data, **kw)[:-4])      # the checksum dropped
            f[4] &= ~(1 << 2)                       # and its flag
            f[6] = (native.xxh32(bytes(f[4:6])) >> 8) & 0xFF
            return bytes(f)
    else:
        raise ValueError(form)
    return call


def _flip(b: bytes) -> bytes:
    if not b:
        return b"\x00"
    m = len(b) // 2
    return b[:m] + bytes([b[m] ^ 0xFF]) + b[m + 1:]


def altered(fn, form: str):
    def call(x, **kw):
        ans = fn(x, **kw)
        if form == "streams":
            return [_flip(ans[0])] + list(ans[1:])
        return _flip(ans)
    return call


def half(fn, form: str):
    def call(x, **kw):
        if form == "frame":
            ans = fn(x, **kw)
            return ans[:len(ans) // 2]
        return fn(x[:len(x) // 2], **kw)
    return call


def stale(fn, form: str):
    first = []

    def call(x, **kw):
        if not first:
            first.append(fn(x, **kw))
        return first[0]
    return call


PLANTS = {"control": control, "altered": altered, "half": half,
          "stale": stale}
