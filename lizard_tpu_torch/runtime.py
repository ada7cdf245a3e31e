"""ctypes binding over the shared native host runtime
(native/lizard_runtime.cpp, built into native/build/liblizard_tpu_runtime.so).

The port uses these of its entry points: the native encoder (`compress`, all
levels 10-49), the scalar block decoder (`decompress`, a cross-check), the
Huff0 stream decoder (`huf_decompress`, for split.split_streams, the
reference batch of levels 30-49), the frame decoder (`decompress_frame`, concatenated frames, a
cross-check), `xxh32` (frame checksums) and `xxh64`, and the device
encoder's host stage: the token emitters (`emit_lz4`, `emit_liz`,
`emit_liz_far`) and the Huff0 stream encoder (`huf_compress`). When the
file is missing or does not load, it is built with the command of
tools/build_native.sh, into a temporary file that then replaces the
library, both under an exclusive lock on native/build/.lock: several
processes may start at once (test workers), and none loads a half-written
library. There is no pure-Python fallback:
without the library every call raises RuntimeError, and `available()`
returns False.

`own_library` builds the port's own host sources the same way, with g++
into build/lizard_tpu_torch/ under that directory's lock:
csrc/xxh32_stream.cpp (`XXH32`, a streaming xxh32 over chunks, for the
incremental frame layer, whose checksums see the content a piece at a
time), csrc/split_plan.cpp (the decoder's host split and Huff0 plan,
ops/host_plan.py) and csrc/huf_plan.cpp (the encoder's Huff0 plan,
ops/enc_huf.py).
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

from lizard_tpu_torch.errors import CorruptError, HufError

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_SO = os.path.join(_BUILD_DIR, "liblizard_tpu_runtime.so")
_SRC = os.path.join(_ROOT, "native", "lizard_runtime.cpp")
_lib = None


def _build_and_open(src: str = _SRC, so: str = _SO) -> ctypes.CDLL:
    """Open the library `so`, building it from `src` first if it is missing
    or does not load; the build writes a temporary file and renames it onto
    `so`, all under the lock of its directory."""
    build_dir = os.path.dirname(so)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            try:
                return ctypes.CDLL(so)
            except OSError:
                pass            # a partial file: build it anew
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
               "-o", tmp, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(so)} failed ({' '.join(cmd)}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)
        return ctypes.CDLL(so)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _build_and_open()
    lib.ltpu_xxh32.restype = ctypes.c_uint32
    lib.ltpu_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_uint32]
    lib.ltpu_xxh64.restype = ctypes.c_uint64
    lib.ltpu_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_uint64]
    lib.ltpu_frame_decompress.restype = ctypes.c_int64
    lib.ltpu_frame_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.c_char_p, ctypes.c_size_t]
    lib.ltpu_decompress.restype = ctypes.c_int64
    lib.ltpu_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ltpu_huf_decompress.restype = ctypes.c_int
    lib.ltpu_huf_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
    lib.ltpu_compress.restype = ctypes.c_int64
    lib.ltpu_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_int, ctypes.c_int]
    lib.ltpu_huf_compress.restype = ctypes.c_int64
    lib.ltpu_huf_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ltpu_emit_lz4.restype = ctypes.c_int64
    lib.ltpu_emit_lz4.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  i64p, i64p, i64p, ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int64]
    lib.ltpu_emit_liz.restype = ctypes.c_int64
    lib.ltpu_emit_liz.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  i64p, i64p, i64p, ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int64, ctypes.c_char_p, i64p]
    lib.ltpu_emit_liz_far.restype = ctypes.c_int64
    lib.ltpu_emit_liz_far.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, i64p,
        ctypes.c_char_p, ctypes.c_int64, i64p,
        ctypes.c_char_p, i64p, ctypes.c_char_p, i64p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library loads (it is built first if missing)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def xxh32(data: bytes, seed: int = 0) -> int:
    return _load().ltpu_xxh32(data, len(data), seed)


def xxh64(data: bytes, seed: int = 0) -> int:
    return _load().ltpu_xxh64(data, len(data), seed)


def own_library(name: str) -> ctypes.CDLL:
    """The library of the port's host source csrc/<name>.cpp, built first
    if missing into build/lizard_tpu_torch/; its file name carries a hash
    of the source, so an edited source builds anew."""
    src = os.path.join(_ROOT, "lizard_tpu_torch", "csrc", f"{name}.cpp")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return _build_and_open(src, os.path.join(
        _ROOT, "build", "lizard_tpu_torch", f"lib{name}-{h}.so"))


_stream_lib = None


def _load_stream() -> ctypes.CDLL:
    """The library of csrc/xxh32_stream.cpp (own_library)."""
    global _stream_lib
    if _stream_lib is None:
        lib = own_library("xxh32_stream")
        lib.ltt_xxh32_state_size.restype = ctypes.c_int
        lib.ltt_xxh32_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.ltt_xxh32_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_size_t]
        lib.ltt_xxh32_digest.restype = ctypes.c_uint32
        lib.ltt_xxh32_digest.argtypes = [ctypes.c_void_p]
        _stream_lib = lib
    return _stream_lib


class XXH32:
    """Streaming xxh32 in native code: the interface and digests of
    utils/xxh.py::XXH32 (update(bytes) -> self, digest() -> int)."""

    def __init__(self, seed: int = 0):
        lib = _load_stream()
        self._state = ctypes.create_string_buffer(lib.ltt_xxh32_state_size())
        lib.ltt_xxh32_reset(self._state, seed)

    def update(self, data: bytes) -> "XXH32":
        data = bytes(data)
        _load_stream().ltt_xxh32_update(self._state, data, len(data))
        return self

    def digest(self) -> int:
        return _load_stream().ltt_xxh32_digest(self._state)


def decompress(src: bytes, max_out: int) -> bytes:
    """Scalar block-stream decode (Lizard_decompress_safe equivalent)."""
    dst = ctypes.create_string_buffer(max(max_out, 1))
    n = _load().ltpu_decompress(src, len(src), dst, max_out)
    if n < 0:
        raise CorruptError(f"native decompress failed ({n})")
    return dst.raw[:n]


def decompress_frame(src: bytes, max_out: int) -> bytes:
    """Native decode of a sequence of concatenated frames, skippable ones
    included, into at most max_out bytes (LizardF_decompress)."""
    dst = ctypes.create_string_buffer(max(max_out, 1))
    n = _load().ltpu_frame_decompress(src, len(src), dst, max_out)
    if n < 0:
        raise CorruptError(f"native frame decompress failed ({n})")
    return dst.raw[:n]


def huf_decompress(src: bytes, dst_size: int) -> bytes:
    """Huff0 stream decode of `src` into exactly `dst_size` bytes."""
    dst = ctypes.create_string_buffer(max(dst_size, 1))
    if _load().ltpu_huf_decompress(src, len(src), dst, dst_size) != 0:
        raise HufError("native huf decode failed")
    return dst.raw[:dst_size]


def compress(data: bytes, level: int = 11, accel: int = 1,
             max_out: int | None = None) -> bytes:
    """Native block-stream compression, all levels 10..49 (fastLZ4
    codewords for 10-19/30-39, LIZv1 for 20-29/40-49, Huff0 stage at >= 30).
    Valid streams for the level, not byte-identical to the reference
    encoder."""
    if not 10 <= level <= 49:
        raise ValueError(f"invalid level {level}")
    cap = (len(data) + len(data) // 2 + 4096 if max_out is None
           else max_out)
    dst = ctypes.create_string_buffer(max(cap, 1))
    r = _load().ltpu_compress(data, len(data), dst, cap, level, accel)
    if r == -1:
        raise ValueError("compressed size exceeds max_out")
    if r < 0:
        raise RuntimeError("native compression failed")
    return dst.raw[:r]


def huf_compress(data: bytes) -> bytes:
    """Native Huff0 compression (4 streams). b"" when the stream does not
    compress (HUF_compress returning 0): the caller stores it raw."""
    cap = len(data) + 1024
    dst = ctypes.create_string_buffer(cap)
    r = _load().ltpu_huf_compress(data, len(data), dst, cap)
    if r < 0:
        raise RuntimeError("native huf compression overflowed its buffer")
    return dst.raw[:r]


def _tokens(st, ml, off):
    """The token arrays as contiguous int64 numpy arrays, and their
    pointers."""
    arrs = [np.ascontiguousarray(a, np.int64) for a in (st, ml, off)]
    i64p = ctypes.POINTER(ctypes.c_int64)
    return arrs, [a.ctypes.data_as(i64p) for a in arrs]


def emit_lz4(data: bytes, st, ml, off) -> tuple[bytes, bytes]:
    """fastLZ4 codewords of a token list (start, length, offset arrays in
    parse order): (flags, literals) stream bytes."""
    arrs, ptrs = _tokens(st, ml, off)
    nt = len(arrs[0])
    cap = len(data) + nt * 10 + 32
    flags = ctypes.create_string_buffer(max(nt, 1))
    lits = ctypes.create_string_buffer(cap)
    r = _load().ltpu_emit_lz4(data, len(data), *ptrs, nt, flags, lits, cap)
    if r < 0:
        raise RuntimeError("emit_lz4 overflowed its buffer")
    return flags.raw[:nt], lits.raw[:r]


def emit_liz(data: bytes, st, ml, off) -> tuple[bytes, bytes, bytes]:
    """LIZv1 codewords of a token list whose offsets are all < 2^16 (a
    repeated offset takes the rep class): (flags, literals, off16)."""
    arrs, ptrs = _tokens(st, ml, off)
    nt = len(arrs[0])
    cap = len(data) + nt * 10 + 32
    flags = ctypes.create_string_buffer(max(nt, 1))
    lits = ctypes.create_string_buffer(cap)
    off16 = ctypes.create_string_buffer(max(nt * 2, 1))
    olen = ctypes.c_int64(0)
    r = _load().ltpu_emit_liz(data, len(data), *ptrs, nt, flags, lits, cap,
                              off16, ctypes.byref(olen))
    if r < 0:
        raise RuntimeError("emit_liz overflowed its buffer")
    return flags.raw[:nt], lits.raw[:r], off16.raw[:olen.value]


def emit_liz_far(data: bytes, st, ml, off) -> tuple[bytes, bytes, bytes,
                                                    bytes]:
    """LIZv1 codewords of a token list with the full codeword set, the
    off24 class for offsets >= 2^16 included: (flags, literals, off16,
    off24)."""
    arrs, ptrs = _tokens(st, ml, off)
    nt = len(arrs[0])
    cap = len(data) + nt * 10 + 32
    fcap = 2 * nt + 8          # a literal carrier and a long-offset token
    flags = ctypes.create_string_buffer(fcap)
    lits = ctypes.create_string_buffer(cap)
    off16 = ctypes.create_string_buffer(max(nt * 2, 1))
    off24 = ctypes.create_string_buffer(max(nt * 3, 1))
    nf, nl, n16, n24 = (ctypes.c_int64(0) for _ in range(4))
    r = _load().ltpu_emit_liz_far(
        data, len(data), *ptrs, nt, flags, fcap, ctypes.byref(nf), lits,
        cap, ctypes.byref(nl), off16, ctypes.byref(n16), off24,
        ctypes.byref(n24))
    if r < 0:
        raise RuntimeError("emit_liz_far overflowed its buffer")
    return (flags.raw[:nf.value], lits.raw[:nl.value],
            off16.raw[:n16.value], off24.raw[:n24.value])
