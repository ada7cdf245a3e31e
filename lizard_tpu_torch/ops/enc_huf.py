"""Huff0 encode on the card: the port of lizard_tpu/ops/enc_huf.py (its host
side `pack_streams`, `unpack_streams`, `huf_compress_tpu`, and its Pallas
kernel `_henc_kernel`, here the CUDA kernel csrc/huf_encode.cu), batched:
one launch packs every bitstream of a batch of streams.

A Huff0 blob (HUF_compress, 4 streams) is a weights header, a 6-byte jump
table and four bitstreams, one per segment of ceil(n/4), ceil(n/4),
ceil(n/4) and the rest of the stream's n bytes. Each bitstream is the
segment's symbols' canonical codes concatenated LSB first from the
segment's last byte down to its first (`emission_order`), then an end-mark
bit. The host plan (`plan_huf_streams`) applies the reference's gates to
each stream, builds the code table and weights header of each stream that
passes (ref/huf_encode.py) and lays the batch out; the kernel packs every
segment's codes into 32-bit little-endian words; `finish` cuts the words
into bitstreams and assembles the blobs with the reference's last gates.
The plan is one native pass over the batch (csrc/huf_plan.cpp, built by
runtime.own_library); `plan_huf_streams_plain` is the same plan in Python
over ref/huf_encode.py, which the tests hold the native pass against. The
counter "huf_plan.native_streams" adds up the streams the native pass
planned, stored and RLE ones included.
None of the TPU layout is kept: no 8-stream sublane packing, no (8, 128)
tiles, no host reordering of the symbols (the kernel reads them backwards).
The pack kernel packs a segment with a thread block, each warp a
contiguous piece of it, PACK_STEP symbols a step: the bit offsets are a
prefix sum across the block; a prep kernel before it zeroes the words and
orders the segments longest first.

`huf_pack` is the kernel wrapper; `huf_pack_plain` is the plain PyTorch
version with the same signature and outputs. A CPU tensor goes to the
plain version; a CUDA tensor launches the kernel or raises.
`huf_pack_profile` launches the kernel's profiling instance. Its calls and
kernels are counted in utils/profiling.py as "huf_pack.launches" and
"huf_pack.kernel_launches".
"""

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from lizard_tpu_torch import runtime
from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.format.constants import HUF_BLOCKSIZE_MAX
from lizard_tpu_torch.ops import _build
from lizard_tpu_torch.ops.host_plan import _ptr
from lizard_tpu_torch.ref.huf_encode import (
    HUF_TABLELOG_DEFAULT,
    fse_count,
    fse_optimal_table_log,
    huf_build_ctable,
    huf_write_ctable,
)
from lizard_tpu_torch.utils import profiling

MAXBITS = 11                   # HUF_TABLELOG_DEFAULT: codes are <= 11 bits
SEGMENTS = 4                   # per stream, in order
TABLE_ENTRIES = 256            # one code per byte value
FIELDS = 4                     # segment row: src_off, len, table_row, out_word_off
PACK_STEP = 512                # symbols a warp packs a step (csrc)
PACK_WHOLE = 17861             # a segment up to this long: one round (csrc)
PACK_ROUND = 6016              # the symbols of a round past it (csrc)
PROF_FIELDS = 9                # huf_pack_profile's columns
HEADER_MAX = 128               # bytes of a weights header, at most (csrc)

# per-segment status codes, shared with csrc/huf_encode.cu
OK = 0
ERR_NO_CODE = -1     # a symbol whose table entry has nbits 0 (or above 32)
ERR_OVERFLOW = -2    # the bits and the end mark exceed the segment's words
ERR_BOUNDS = -3      # a row outside its tensors (a caller's fault)
STATUS_TEXT = {
    ERR_NO_CODE: "a symbol has no code in its table",
    ERR_OVERFLOW: "the bitstream exceeds its output words",
    ERR_BOUNDS: "segment row outside its tensors",
}


def emission_order(n: int) -> np.ndarray:
    """The reference's symbol order of a segment of n bytes
    (huf_compress.c:427-470): the tail bytes n2+2, n2+1, n2 (n2 = n & ~3,
    those below n) first, then n2-1 down to 0. That is n-1 down to 0, the
    order in which the kernel reads the segment."""
    return np.arange(n - 1, -1, -1, dtype=np.int64)


def segment_words(length):
    """Output words reserved for a segment of `length` symbols: its codes of
    at most MAXBITS bits and the end mark, ceil(length * 11 / 32) + 1."""
    return (length * MAXBITS + 31) // 32 + 1


@dataclass
class HufEncPlan:
    """The host plan of one batch of streams to Huff0-code, on the CPU.

    `blobs[i]` is stream i's result where the plan already knows it (None:
    stored raw; one byte: RLE) and is filled in by `finish` for the coded
    streams. Coded stream t (`coded[t]` its index in the batch) has table
    row t, header `headers[t]` and four consecutive rows of `segs`."""
    data: torch.Tensor         # uint8 (n_bytes,): the coded streams' bytes
    segs: torch.Tensor         # int64 (4 * n_coded, 4): src_off, len,
                               # table_row, out_word_off
    tables: torch.Tensor       # int32 (n_coded, 256): nbits << 16 | code
    n_words: int               # output words of the whole batch
    coded: list[int]
    headers: list[bytes]
    blobs: list

    def stage(self, device) -> dict:
        """The kernel inputs on `device`, as keyword arguments of huf_pack."""
        profiling.count_bytes("h2d_bytes", self.data, self.segs, self.tables)
        return {"data": self.data.to(device), "segs": self.segs.to(device),
                "tables": self.tables.to(device), "n_words": self.n_words}


def plan_huf_streams_plain(streams) -> HufEncPlan:
    """The host plan of HUF_compress for every stream of `streams`, with the
    gates of huf_compress_tpu (lizard_tpu/ops/enc_huf.py:304-320): an empty
    stream is stored; a stream of one byte value is RLE (its first byte);
    one whose largest count is at most n/128 + 1 is stored; one whose
    header and 12 bytes are not below n is stored. A stream over 128 KB
    and one whose weights have no valid header are stored, as the native
    encoder does. Each stream that passes gets its code table, weights
    header and four segments."""
    parts, rows, tables, coded, headers, blobs = [], [], [], [], [], []
    cursor = words = 0
    for i, src in enumerate(streams):
        src = bytes(src)
        n = len(src)
        blobs.append(None)
        if n == 0 or n > HUF_BLOCKSIZE_MAX:
            continue
        count, max_sym, largest = fse_count(src, 255)
        if largest == n:
            blobs[i] = src[:1]
            continue
        if largest <= (n >> 7) + 1:
            continue
        huff_log = fse_optimal_table_log(HUF_TABLELOG_DEFAULT, n, max_sym,
                                         minus=1)
        nb, val, huff_log = huf_build_ctable(count, max_sym, huff_log)
        header = huf_write_ctable(nb, max_sym, huff_log)
        if header is None or len(header) + 12 >= n:
            continue
        table = np.zeros(TABLE_ENTRIES, np.int32)
        table[:max_sym + 1] = (np.asarray(nb, np.int32) << 16) \
            | np.asarray(val, np.int32)
        seg = (n + 3) // 4
        for k in range(SEGMENTS):
            length = seg if k < 3 else n - 3 * seg
            rows.append((cursor + k * seg, length, len(tables), words))
            words += segment_words(length)
        parts.append(src)
        cursor += n
        tables.append(table)
        coded.append(i)
        headers.append(header)
    return HufEncPlan(
        data=torch.from_numpy(np.frombuffer(b"".join(parts), np.uint8).copy()),
        segs=torch.tensor(rows, dtype=torch.int64).reshape(-1, FIELDS),
        tables=torch.from_numpy(np.stack(tables) if tables else
                                np.zeros((0, TABLE_ENTRIES), np.int32)),
        n_words=words, coded=coded, headers=headers, blobs=blobs)


# csrc/huf_plan.cpp: its status codes (the plain version's ValueErrors),
# the fields of err[] and sizes[], and the kind of a stream of one byte
# value (the others: 0 stored, 2 coded)
PLAN_TEXT = {1: "huffLog too large", 2: "normalizeM2 failed",
             3: "writeNCount failed", 4: "writeNCount overran symbols",
             5: "ctable spread failed"}
ERR_CODE, ERR_STREAM = range(2)
SZ_CODED, SZ_BYTES, SZ_WORDS = range(3)
RLE = 1


@functools.cache
def _plan_lib() -> ctypes.CDLL:
    """csrc/huf_plan.cpp (runtime.own_library), its entry declared and its
    constants checked against this module's."""
    lib = runtime.own_library("huf_plan")
    consts = (ctypes.c_int64 * 7)()
    lib.ltt_huf_plan_consts(consts)
    if tuple(consts) != (ERR_STREAM + 1, SZ_WORDS + 1, TABLE_ENTRIES,
                         SEGMENTS, FIELDS, HEADER_MAX, HUF_BLOCKSIZE_MAX):
        raise RuntimeError("csrc/huf_plan.cpp does not match ops/enc_huf.py")
    lib.ltt_huf_plan.restype = ctypes.c_int64
    lib.ltt_huf_plan.argtypes = ([ctypes.c_int64, ctypes.c_char_p]
                                 + [ctypes.c_void_p] * 10)
    return lib


def plan_huf_streams(streams) -> HufEncPlan:
    """plan_huf_streams_plain in one native pass over the batch (csrc/
    huf_plan.cpp), one ctypes call whatever the number of streams: the
    streams go joined, with their offsets; the outputs are allocated for
    every stream and the pass fills the first rows. Equal to the plain plan
    field for field; `data`, `segs` and `tables` are views of the first
    rows of the outputs."""
    bufs = [s if isinstance(s, bytes) else bytes(s) for s in streams]
    n = len(bufs)
    offs = np.zeros(n + 1, np.int64)
    offs[1:] = np.cumsum(np.fromiter(map(len, bufs), np.int64, n))
    joined = b"".join(bufs)
    kind = np.empty(n, np.int8)
    coded = np.empty(n, np.int64)
    data = torch.empty(len(joined), dtype=torch.uint8)
    segs = torch.empty((SEGMENTS * n, FIELDS), dtype=torch.int64)
    tables = torch.empty((n, TABLE_ENTRIES), dtype=torch.int32)
    heads = np.empty(n * HEADER_MAX, np.uint8)
    head_len = np.empty(n, np.int64)
    sizes = np.zeros(SZ_WORDS + 1, np.int64)
    err = np.zeros(ERR_STREAM + 1, np.int64)
    if _plan_lib().ltt_huf_plan(n, joined, *map(_ptr, (
            offs, kind, coded, data, segs, tables, heads, head_len, sizes,
            err))):
        code = int(err[ERR_CODE])
        raise ValueError(PLAN_TEXT.get(
            code, f"huf_plan failed with status {code}"))
    n_coded, n_bytes, n_words = sizes.tolist()
    raw = heads[:n_coded * HEADER_MAX].tobytes()
    headers = [raw[t * HEADER_MAX:t * HEADER_MAX + k]
               for t, k in enumerate(head_len[:n_coded].tolist())]
    blobs = [None] * n
    for i in np.flatnonzero(kind == RLE).tolist():
        blobs[i] = bufs[i][:1]
    profiling.count("huf_plan.native_streams", n)
    return HufEncPlan(data=data[:n_bytes], segs=segs[:SEGMENTS * n_coded],
                      tables=tables[:n_coded], n_words=n_words,
                      coded=coded[:n_coded].tolist(), headers=headers,
                      blobs=blobs)


def _check(data, segs, tables, n_words):
    """Types, shapes, devices and contiguity, on the host. The rows of
    `segs` are not read here (that would wait for the device): the kernel
    and the plain version check each row's bounds themselves."""
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    for name, t, dtype, shape in (
            ("segs", segs, torch.int64, (segs.shape[0], FIELDS)),
            ("tables", tables, torch.int32, (tables.shape[0], TABLE_ENTRIES))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
    if segs.shape[0] % SEGMENTS:
        raise ValueError("segs must hold 4 rows per stream")
    if n_words < 0:
        raise ValueError("n_words must be >= 0")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu, not {data.device}")


def huf_pack(data, segs, tables, n_words: int):
    """Pack every segment of a staged plan (HufEncPlan.stage) into 32-bit
    little-endian words. Segment s packs its len symbols data[src_off:
    src_off + len], read from the last to the first, each as the (code,
    nbits) of tables[table_row]; the codes are concatenated LSB first into
    words out_word_off .. out_word_off + segment_words(len), followed by the
    end-mark bit. The four rows of a stream name one table.

    Returns (words, bits, status): words int32 (n_words,), bits int64 per
    segment (the code bits, without the end mark), status int32 per
    segment: 0 = ok, negative (STATUS_TEXT) = the segment's words are zero
    and its bits 0. CUDA tensors launch csrc/huf_encode.cu on the current
    stream without synchronising; CPU tensors run huf_pack_plain."""
    _check(data, segs, tables, n_words)
    if data.device.type == "cpu":
        return huf_pack_plain(data, segs, tables, n_words)
    return _pack_launch(data, segs, tables, n_words, None)


def huf_pack_profile(data, segs, tables, n_words: int):
    """huf_pack on CUDA tensors with a profile beside its outputs: (words,
    bits, status, prof int64 (segments, PROF_FIELDS)), prof's columns per
    segment (a thread block each) thread 0's clock cycles from the block's
    start to its end, of which in setting up (the row, the table, the word
    buffer zeroed), loading the symbols, looking up and counting their
    bits (with the warp scans), the scan across the block (its barriers
    included), scattering the codes into shared memory, and storing the
    words; the rounds (1 for a segment of up to PACK_WHOLE symbols, else
    one a PACK_ROUND); the block's ns on the card's global timer. A row out
    of bounds has a row of zeros. It launches the pack kernel's profiling
    instance (the plain call reads no clock). Counts as one huf_pack
    call."""
    _check(data, segs, tables, n_words)
    if data.device.type != "cuda":
        raise ValueError(f"huf_pack_profile runs on cuda, not {data.device}")
    prof = torch.zeros((segs.shape[0], PROF_FIELDS), dtype=torch.int64,
                       device=data.device)
    return (*_pack_launch(data, segs, tables, n_words, prof), prof)


@functools.cache
def _launcher():
    """csrc/huf_encode.cu's C entry, built and typed once."""
    fn = _build.load("huf_encode").huf_pack_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _pack_launch(data, segs, tables, n_words: int, prof):
    """One call of csrc/huf_encode.cu on CUDA tensors: its prep kernel
    (the words zeroed: a word that no row in bounds covers stays 0, as in
    the plain version; the rows ordered longest first, into scratch words
    past n_words) and its pack kernel; `prof` (int64 (segments,
    PROF_FIELDS), or None) receives the profile."""
    dev = data.device
    S = segs.shape[0]
    scratch = torch.empty(n_words + S, dtype=torch.int32, device=dev)
    bits = torch.empty(S, dtype=torch.int64, device=dev)
    status = torch.empty(S, dtype=torch.int32, device=dev)
    err = _launcher()(
        dev.index, data.data_ptr(), data.numel(), segs.data_ptr(), S,
        tables.data_ptr(), tables.shape[0], scratch.data_ptr(), n_words,
        bits.data_ptr(), status.data_ptr(),
        None if prof is None else prof.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"huf_pack launch failed: cudaError {err}")
    # "launches": calls that launched the pack kernel; "kernel_launches":
    # kernels launched, 2 a call (prep, pack)
    if S:
        profiling.count("huf_pack.launches")
        profiling.count("huf_pack.kernel_launches", 2)
    elif n_words:
        profiling.count("huf_pack.kernel_launches")
    return scratch[:n_words], bits, status


def _status(data, segs, tables, n_words):
    """(status, the symbols' segment, source index, table entry) of every
    segment row: ERR_BOUNDS for a row outside its tensors (its source
    outside data, its table row out of range or not its stream's, its
    words outside n_words), ERR_NO_CODE for a symbol whose entry has nbits
    0 or above 32, ERR_OVERFLOW for bits + 1 above 32 words per reserved
    word, else OK. The kernel makes the same tests in this order."""
    dev = data.device
    src_off, length, row, out_off = segs.unbind(1)
    m = tables.shape[0]
    stream_row = row[::SEGMENTS].repeat_interleave(SEGMENTS)
    inside = ((stream_row >= 0) & (stream_row < m) & (row == stream_row)
              & (src_off >= 0) & (length >= 0)
              & (src_off + length <= data.numel()) & (out_off >= 0)
              & (out_off + segment_words(length) <= n_words))
    used = torch.where(inside, length, 0)
    seg_of = torch.repeat_interleave(torch.arange(segs.shape[0], device=dev),
                                     used)
    start = torch.cumsum(used, 0) - used
    k = torch.arange(seg_of.numel(), device=dev) - start[seg_of]
    src = src_off[seg_of] + length[seg_of] - 1 - k        # emission order
    entry = tables.long().flatten()[row[seg_of] * TABLE_ENTRIES
                                    + data[src].long()]
    nb = entry >> 16
    bad = torch.zeros(segs.shape[0], dtype=torch.int64, device=dev)
    bad.index_add_(0, seg_of, ((nb == 0) | (nb > 32)).long())
    total = torch.zeros(segs.shape[0], dtype=torch.int64, device=dev)
    total.index_add_(0, seg_of, nb)
    status = torch.where(total + 1 > 32 * segment_words(length),
                         ERR_OVERFLOW, OK)
    status = torch.where(bad > 0, ERR_NO_CODE, status)
    status = torch.where(inside, status, ERR_BOUNDS)
    return status, seg_of, k, entry, total


def huf_pack_plain(data, segs, tables, n_words: int):
    """The plain PyTorch version of huf_pack: same inputs, same outputs.

    Vectorised over every symbol of the batch: gather each symbol's (code,
    nbits) in emission order, take the bit offsets by a cumsum within each
    segment, put each code's low part and its spill into the next word into
    32-bit words held in int64. Codes never share a bit, so adding them
    (index_add_) is their OR. Then the end mark of each segment."""
    _check(data, segs, tables, n_words)
    dev = data.device
    S = segs.shape[0]
    words = torch.zeros(n_words, dtype=torch.int64, device=dev)
    status, seg_of, k, entry, total = _status(data, segs, tables, n_words)
    ok = status == OK
    keep = ok[seg_of]
    seg_of, entry = seg_of[keep], entry[keep]
    nb = entry >> 16
    code = entry & 0xFFFF & ((1 << nb) - 1)
    cum = torch.cumsum(nb, 0)
    seg_bits = torch.zeros(S, dtype=torch.int64, device=dev)
    seg_bits.index_add_(0, seg_of, nb)
    base = torch.cumsum(seg_bits, 0) - seg_bits
    off = cum - nb - base[seg_of]                       # within the segment
    out_off = segs[:, 3]
    w = out_off[seg_of] + (off >> 5)
    sh = off & 31
    words.index_add_(0, w, (code << sh) & 0xFFFFFFFF)
    cross = sh + nb > 32
    words.index_add_(0, torch.where(cross, w + 1, w),
                     torch.where(cross, code >> (32 - sh), 0))
    bits = torch.where(ok, total, 0)
    end = torch.nonzero(ok).flatten()
    words.index_add_(0, out_off[end] + (bits[end] >> 5),
                     torch.ones_like(end) << (bits[end] & 31))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32), bits, status.to(torch.int32)


def raise_on_status(status, plan: HufEncPlan) -> None:
    """Raise RuntimeError naming the stream (its index in the batch) of the
    first segment whose status is not OK."""
    profiling.count_bytes("d2h_bytes", status)
    st = status.cpu()
    bad = torch.nonzero(st != OK).flatten()
    if bad.numel():
        s = int(bad[0])
        raise RuntimeError(f"huf_pack: stream {plan.coded[s // SEGMENTS]}, "
                           f"segment {s % SEGMENTS}: "
                           f"{STATUS_TEXT[int(st[s])]}")


def finish(plan: HufEncPlan, words, bits) -> list:
    """The blobs of every stream of the plan from huf_pack's words and bits
    (on any device; copied to the host): each segment's bitstream is its
    first (bits + 1 + 7) // 8 bytes, end mark included. A stream with an
    empty bitstream or one over 0xFFFF bytes is stored, as is one whose
    blob (header, the three LE16 sizes of the first bitstreams, the four
    bitstreams) is not below n - 1 bytes (huf_compress_tpu l.326-334).
    Returns plan.blobs, filled in."""
    with profiling.span("huf_readback", "device"):
        profiling.count_bytes("d2h_bytes", words, bits)
        raw = words.cpu().numpy().astype("<i4").tobytes()
        b = bits.cpu().tolist()
    with profiling.span("huf_finish", "host"):
        segs = plan.segs.tolist()
        for t, i in enumerate(plan.coded):
            parts = []
            for s in range(SEGMENTS * t, SEGMENTS * (t + 1)):
                w0 = 4 * segs[s][3]
                parts.append(raw[w0:w0 + (b[s] + 1 + 7) // 8])
            n = sum(segs[s][1]
                    for s in range(SEGMENTS * t, SEGMENTS * (t + 1)))
            if any(len(p) == 0 or len(p) > 0xFFFF for p in parts):
                continue
            jump = b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
            out = plan.headers[t] + jump + b"".join(parts)
            if len(out) < n - 1:
                plan.blobs[i] = out
        return plan.blobs


def huf_compress_batch(streams, device=None) -> list:
    """HUF_compress of every stream of `streams` on `device` (the card
    unless device="cpu") with one huf_pack call: the batched counterpart of
    lizard_tpu/ops/enc_huf.py::huf_compress_tpu. Returns per stream the
    Huff0 blob, its first byte (RLE), or None (store it raw); each equal to
    the reference's HUF_compress (lizard_tpu/ref/huf_encode.py::
    huf_compress) and to the native ltpu_huf_compress. A batch with no
    stream to code launches nothing; a status that is not OK raises."""
    dev = resolve_device(device)
    with profiling.span("huf_plan", "host"):
        plan = plan_huf_streams(streams)
    if not plan.coded:
        return plan.blobs
    with profiling.span("huf_pack", "device"):
        words, bits, status = huf_pack(**plan.stage(dev))
    with profiling.span("huf_readback", "device"):
        raise_on_status(status, plan)
    return finish(plan, words, bits)
