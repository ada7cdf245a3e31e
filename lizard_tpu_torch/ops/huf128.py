"""Huff0 entropy decode on the card: the port of lizard_tpu/ops/huf128.py
(prepare_huf128, huf_decompress_128, and its Pallas kernels, here the one
CUDA kernel csrc/huf_decode.cu). The module keeps the JAX module's name.

A Huff0 blob (levels 30-49 code the flags and literals streams with it) is
a weights header, a 6-byte jump table and four backward bitstreams
("segments") of ceil(orig/4), ceil(orig/4), ceil(orig/4) and the rest of
the output bytes (ref/huf.py::huf_decompress). The host plan
(`prepare_huf128`) parses each blob's header, builds its decode table and
checks its layout; the kernel then decodes every segment of the batch
straight to its destination: one of four byte tensors (on the main path
the LZ decoder's staged flags, literals, off16 and off24 streams) at a
given offset. The TPU kernels needed a canonical-rank pass (translate) and
a compaction pass because Pallas has no table gather and its cells
scatter a stream's segments; on the card the table lookup gives the symbol
and each segment stores where it belongs, so neither pass exists here and
none of the TPU layout (byte reversal, word packing, meta planes, cells,
episodes) is built.

`huf_decode` is the kernel wrapper; `huf_decode_plain` is the plain
PyTorch version with the same signature and outputs. A CPU tensor goes to
the plain version; a CUDA tensor launches the kernel or raises. Its calls
are counted in utils/profiling.py as "huf_decode.launches".
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.errors import HufError
from lizard_tpu_torch.ops import _build
from lizard_tpu_torch.ref.huf import HUF_TABLELOG_MAX, huf_read_stats
from lizard_tpu_torch.utils import profiling

TABLE_ENTRIES = 1 << HUF_TABLELOG_MAX      # every table padded to 4096
SEGMENTS = 4                               # per blob, in order

# per-segment status codes, shared with csrc/huf_decode.cu
OK = 0
ERR_NOT_CONSUMED = -1   # the bitstream was not consumed exactly
ERR_END_MARK = -2       # last byte 0 (the host plan rejects it first)
ERR_BOUNDS = -3         # a row outside its tensors (a caller's fault)
STATUS_TEXT = {
    ERR_NOT_CONSUMED: "huf stream not exactly consumed",
    ERR_END_MARK: "missing end mark",
    ERR_BOUNDS: "segment table row outside its tensors",
}


@dataclass
class HufPlan:
    """The host plan of one batch of Huff0 blobs, on the CPU.

    Every blob that needs the kernel gives four consecutive rows of
    `segs` (its segments, in order) and one decode table; `names[t]`
    names the blob of table t in error messages. RLE and stored blobs
    are in `fills` as (dst_kind, dst_off, bytes): the host writes them."""
    data: torch.Tensor         # uint8 [n_bytes]: the segments' bytes
    segs: torch.Tensor         # int64 (n_seg, 6): src_off, src_len,
                               # dst_kind, dst_off, n_out, table_id
    tables: torch.Tensor       # uint16 (n_tables, 4096): sym | nbits << 8
    table_log: torch.Tensor    # int32 (n_tables,)
    names: list[str]
    fills: list[tuple[int, int, bytes]]

    def stage(self, device) -> dict:
        """The kernel inputs on `device`, as keyword arguments of
        huf_decode (the destinations apart)."""
        host = {"data": self.data, "segs": self.segs, "tables": self.tables,
                "table_log": self.table_log}
        with profiling.span("stage", "device"):
            args = {k: t.to(device) for k, t in host.items()}
        profiling.count_bytes("h2d_bytes", *host.values())
        return args


def decode_table(weights, table_log: int) -> np.ndarray:
    """The canonical X1 decode table of ref/huf.py::huf_build_dtable as
    4096 uint16 entries sym | nbits << 8 (entries past 1 << table_log are
    0): symbols by ascending weight, then ascending value, each repeated
    (1 << w) >> 1 times with nbits = table_log + 1 - w."""
    w = np.asarray(weights, np.int64)
    order = np.nonzero(w)[0]
    order = order[np.argsort(w[order], kind="stable")]
    reps = (1 << w[order]) >> 1
    entries = order | ((table_log + 1 - w[order]) << 8)
    table = np.zeros(TABLE_ENTRIES, np.uint16)
    table[:1 << table_log] = np.repeat(entries, reps)
    return table


def prepare_huf128(blobs, dests=None, names=None) -> HufPlan:
    """The host plan of `blobs`, a list of (blob bytes, decoded size).

    dests[i] = (dst_kind, dst_off) places blob i's output (kind 0-3 picks
    the destination tensor); by default every blob goes to tensor 0, one
    after the other. names[i] names blob i in errors (default "blob i").
    Raises HufError where ref/huf.py::huf_decompress would, except for a
    segment that is not consumed exactly, which only the decode finds."""
    if dests is None:
        offs = np.cumsum([0] + [orig for _, orig in blobs])
        dests = [(0, int(o)) for o in offs[:-1]]
    if names is None:
        names = [f"blob {i}" for i in range(len(blobs))]
    parts, rows, tables, logs, kept, fills = [], [], [], [], [], []
    cursor = 0
    for i, ((blob, orig), (kind, dst)) in enumerate(zip(blobs, dests)):
        blob = bytes(blob)
        if orig == 0:
            raise HufError(f"{names[i]}: dst size 0")
        if len(blob) > orig:
            raise HufError(f"{names[i]}: csize > dsize")
        if len(blob) == orig:                      # stored
            fills.append((kind, dst, blob))
            continue
        if len(blob) == 1:                         # RLE
            fills.append((kind, dst, blob * orig))
            continue
        weights, table_log, hsize = huf_read_stats(blob)
        body = blob[hsize:]
        if len(body) < 10:
            raise HufError(f"{names[i]}: huf body too small")
        lens = [int.from_bytes(body[k:k + 2], "little") for k in (0, 2, 4)]
        lens.append(len(body) - 6 - sum(lens))
        if lens[3] < 0:
            raise HufError(f"{names[i]}: jump table overflow")
        seg = (orig + 3) // 4
        sizes = [seg, seg, seg, orig - 3 * seg]
        if sizes[3] < 0:
            raise HufError(f"{names[i]}: bad segmentation")
        off = 6
        for k, (ln, n_out) in enumerate(zip(lens, sizes)):
            if ln == 0:
                raise HufError(f"{names[i]}, segment {k}: empty bitstream")
            if body[off + ln - 1] == 0:
                raise HufError(f"{names[i]}, segment {k}: missing end mark")
            rows.append((cursor + off - 6, ln, kind, dst + k * seg, n_out,
                         len(tables)))
            off += ln
        parts.append(body[6:])
        cursor += len(body) - 6
        tables.append(decode_table(weights, table_log))
        logs.append(table_log)
        kept.append(names[i])
    data = np.frombuffer(b"".join(parts), np.uint8).copy()
    return HufPlan(
        data=torch.from_numpy(data),
        segs=torch.tensor(rows, dtype=torch.int64).reshape(-1, 6),
        tables=torch.from_numpy(np.stack(tables) if tables else
                                np.zeros((0, TABLE_ENTRIES), np.uint16)),
        table_log=torch.tensor(logs, dtype=torch.int32),
        names=kept, fills=fills)


def _check(data, segs, tables, table_log, dests):
    """Types, shapes, devices and contiguity, on the host. The rows of
    `segs` are not read here (that would wait for the device): the kernel
    and the plain version check each row's bounds themselves."""
    dev = data.device
    named = [("data", data)] + list(zip(("flags", "literals", "off16",
                                         "off24"), dests))
    for name, t in named:
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
    for name, t, dtype, shape in (
            ("segs", segs, torch.int64, (segs.shape[0], 6)),
            ("tables", tables, torch.uint16, (tables.shape[0], TABLE_ENTRIES)),
            ("table_log", table_log, torch.int32, (tables.shape[0],))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor")
    for name, t in named[1:] + [("segs", segs), ("tables", tables),
                                ("table_log", table_log)]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
    if segs.shape[0] % SEGMENTS:
        raise ValueError("segs must hold 4 rows per blob")


def _rows_in_bounds(data, segs, tables, table_log, dests) -> torch.Tensor:
    """Per segment, whether its row is usable: its source inside data
    (and not empty), its output inside its tensor, and its blob's table
    (the one its first row names) in range, with 1 <= tableLog <= 12, and
    named by all four rows. The kernel makes the same test."""
    dev = data.device
    m = tables.shape[0]
    if m == 0:
        return torch.zeros(segs.shape[0], dtype=torch.bool, device=dev)
    src_off, src_len, kind, dst_off, n_out, tid = segs.unbind(1)
    size = torch.tensor([t.numel() for t in dests], device=dev)
    blob_tid = tid[::SEGMENTS].repeat_interleave(SEGMENTS)
    tl = table_log.long()[blob_tid.clamp(0, m - 1)]
    return ((blob_tid >= 0) & (blob_tid < m) & (tl >= 1)
            & (tl <= HUF_TABLELOG_MAX)
            & (tid == blob_tid) & (src_off >= 0) & (src_len >= 1)
            & (src_off + src_len <= data.numel()) & (kind >= 0) & (kind <= 3)
            & (n_out >= 0) & (dst_off >= 0)
            & (dst_off + n_out <= size[kind.clamp(0, 3)]))


def _launcher():
    """The C entry of csrc/huf_decode.cu: every pointer and the stream as
    c_void_p (an undeclared pointer would be cut to 32 bits)."""
    fn = _build.load("huf_decode").huf_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 3)
    return fn


def _launch(data, segs, tables, table_log, dests, rounds) -> torch.Tensor:
    """One launch of csrc/huf_decode.cu on CUDA tensors; `rounds` (int32
    per segment, or None) receives each segment's synchronisation rounds.
    Returns the status tensor."""
    status = torch.empty(segs.shape[0], dtype=torch.int32, device=data.device)
    if segs.shape[0] == 0:
        return status
    fn = _launcher()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), data.numel(), segs.data_ptr(),
                 segs.shape[0], tables.data_ptr(), table_log.data_ptr(),
                 tables.shape[0], *(t.data_ptr() for t in dests),
                 *(t.numel() for t in dests), status.data_ptr(),
                 None if rounds is None else rounds.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"huf_decode launch failed: cudaError {err}")
    profiling.count("huf_decode.launches")
    return status


def huf_decode(data, segs, tables, table_log, flags, literals, off16, off24):
    """Decode every segment of a staged plan (HufPlan.stage) into the four
    destination tensors, in place: segment s's n_out symbols go to
    (flags, literals, off16, off24)[dst_kind] at dst_off.

    Returns the int32 status of each segment: 0 = ok, negative = corrupt
    (STATUS_TEXT); a corrupt segment's bytes are undefined, and a row
    outside its tensors (ERR_BOUNDS) is not decoded at all. CUDA tensors
    launch csrc/huf_decode.cu on the current stream without
    synchronising; CPU tensors run huf_decode_plain."""
    dests = (flags, literals, off16, off24)
    _check(data, segs, tables, table_log, dests)
    with profiling.span("huf_decode", "device"):
        if data.device.type == "cpu":
            return huf_decode_plain(data, segs, tables, table_log, *dests)
        if data.device.type != "cuda":
            raise ValueError(f"huf_decode runs on cuda or cpu, not "
                             f"{data.device}")
        return _launch(data, segs, tables, table_log, dests, None)


def huf_decode_rounds(data, segs, tables, table_log, flags, literals, off16,
                      off24):
    """huf_decode on CUDA tensors, with each segment's synchronisation
    rounds beside the status: (status, rounds int32 per segment). A segment
    whose lanes fell into step with the true path at once took 1 round (0
    if it was not decoded, or its lanes all started on the true path);
    more rounds mean a lane's path never met it within its range (codes of
    one length from a misaligned start: up to 31). Counts as one
    huf_decode call."""
    dests = (flags, literals, off16, off24)
    _check(data, segs, tables, table_log, dests)
    if data.device.type != "cuda":
        raise ValueError(f"huf_decode runs on cuda or cpu, not {data.device}")
    rounds = torch.zeros(segs.shape[0], dtype=torch.int32, device=data.device)
    return _launch(data, segs, tables, table_log, dests, rounds), rounds

# bit_length(b) - 1 for every byte value (-1 for 0)
_HIGHBIT = torch.tensor([b.bit_length() - 1 for b in range(256)])


def huf_decode_plain(data, segs, tables, table_log, flags, literals, off16,
                     off24):
    """The plain PyTorch version of huf_decode: same inputs, same outputs.

    Vectorised across segments and serial across symbols: each step
    gathers the three bytes under every live segment's bit position,
    looks up (sym, nbits) in the stacked tables, and advances; segments
    are sorted longest first, so the live ones are a prefix. The bit
    semantics are those of ref/huf.py::BitReader; rows outside their
    tensors get ERR_BOUNDS, as in the kernel."""
    dests = (flags, literals, off16, off24)
    _check(data, segs, tables, table_log, dests)
    dev = data.device
    n = segs.shape[0]
    status = torch.full((n,), ERR_BOUNDS, dtype=torch.int32, device=dev)
    if n == 0:
        return status
    usable = torch.nonzero(_rows_in_bounds(data, segs, tables, table_log,
                                           dests)).flatten()
    if usable.numel() == 0:
        return status
    rows = segs[usable]
    order = torch.argsort(rows[:, 4], descending=True, stable=True)
    src_off, src_len, kind, dst_off, n_out, tid = rows[order].unbind(1)
    n = order.numel()
    lens = n_out.cpu().tolist()
    tl = table_log.long()[tid]
    mask = (1 << tl) - 1
    lookup = tables.long().flatten()
    tab0 = tid * TABLE_ENTRIES
    # the little-endian 24-bit word at every byte of data
    d = torch.nn.functional.pad(data.long(), (0, 2))
    word3 = d[:-2] | (d[1:-1] << 8) | (d[2:] << 16)
    last = data[src_off + src_len - 1].long()
    pos = (src_len - 1) * 8 + _HIGHBIT.to(dev)[last]   # below the end mark
    out_base = torch.cumsum(n_out, 0) - n_out
    flat = torch.empty(sum(lens), dtype=torch.uint8, device=dev)
    k = n
    for i in range(lens[0]):
        while lens[k - 1] <= i:
            k -= 1
        p = pos[:k]
        # bytes q..q+2 hold bits [8q, 8q+24), which cover [p-tl, p); bytes
        # before the segment's start read as zeros
        q = torch.div(p - 1, 8, rounding_mode="floor") - 2
        w = word3[src_off[:k] + q.clamp(min=0)]
        w = (w << (8 * (-q).clamp(0, 3))) & 0xFFFFFF
        v = (w >> (p - tl[:k] - 8 * q)) & mask[:k]
        v = torch.where(p > 0, v, 0)                   # over-read: zeros
        e = lookup[tab0[:k] + v]
        flat[out_base[:k] + i] = (e & 0xFF).to(torch.uint8)
        pos[:k] -= e >> 8
    st = torch.where(pos == 0, OK, ERR_NOT_CONSUMED)
    st = torch.where(last == 0, ERR_END_MARK, st)
    status[usable[order]] = st.to(torch.int32)
    # scatter each segment's bytes to its destination
    seg_of = torch.repeat_interleave(torch.arange(n, device=dev), n_out)
    at = dst_off[seg_of] + torch.arange(flat.numel(), device=dev) \
        - out_base[seg_of]
    kinds = kind[seg_of]
    for k_id, t in enumerate(dests):
        sel = kinds == k_id
        t[at[sel]] = flat[sel]
    return status


def raise_on_status(status, plan: HufPlan) -> None:
    """Raise HufError naming the first corrupt segment's blob."""
    profiling.count_bytes("d2h_bytes", status)
    st = status.cpu()
    bad = torch.nonzero(st != OK).flatten()
    if bad.numel():
        s = int(bad[0])
        raise HufError(f"{plan.names[s // SEGMENTS]}, segment "
                       f"{s % SEGMENTS}: {STATUS_TEXT[int(st[s])]}")


def huf_decompress_128(blobs, device=None) -> list[bytes]:
    """Decode a batch of Huff0 blobs [(blob, decoded size)] on `device`
    (the card unless device="cpu") in one huf_decode call; returns the
    decoded bytes of each. RLE and stored blobs are filled on the host,
    and a batch of only those launches nothing."""
    dev = resolve_device(device)
    plan = prepare_huf128(blobs)
    offs = np.cumsum([0] + [orig for _, orig in blobs])
    flat = np.zeros(int(offs[-1]), np.uint8)
    if plan.segs.shape[0]:
        out = torch.zeros(flat.size, dtype=torch.uint8, device=dev)
        empty = torch.empty(0, dtype=torch.uint8, device=dev)
        status = huf_decode(**plan.stage(dev), flags=out, literals=empty,
                            off16=empty, off24=empty)
        raise_on_status(status, plan)
        profiling.count_bytes("d2h_bytes", out)
        flat = out.cpu().numpy()
    for _, dst, data in plan.fills:
        flat[dst:dst + len(data)] = np.frombuffer(data, np.uint8)
    return [flat[offs[i]:offs[i + 1]].tobytes() for i in range(len(blobs))]
