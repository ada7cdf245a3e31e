"""ctypes binding over the shared native host runtime
(native/lizard_runtime.cpp, built into native/build/liblizard_tpu_runtime.so).

The port uses four of its entry points: the native encoder (`compress`, all
levels 10-49), the scalar block decoder (`decompress`, a cross-check), the
Huff0 stream decoder (`huf_decompress`, the host entropy route of levels
30-49) and `xxh32` (frame checksums). When the file is missing or does not
load, it is built with the command of tools/build_native.sh, into a
temporary file that then replaces the library, both under an exclusive lock
on native/build/.lock: several processes may start at once (test workers),
and none loads a half-written library. There is no pure-Python fallback:
without the library every call raises RuntimeError.
"""

import ctypes
import fcntl
import os
import subprocess

from lizard_tpu_torch.errors import CorruptError, HufError

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_SO = os.path.join(_BUILD_DIR, "liblizard_tpu_runtime.so")
_SRC = os.path.join(_ROOT, "native", "lizard_runtime.cpp")
_lib = None


def _build_and_open() -> ctypes.CDLL:
    """Open the library, building it first if it is missing or does not
    load; the build writes a temporary file and renames it onto _SO, all
    under the directory's lock."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_SO):
            try:
                return ctypes.CDLL(_SO)
            except OSError:
                pass            # a partial file: build it anew
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
               "-o", tmp, _SRC]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building the native runtime failed ({' '.join(cmd)}):\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, _SO)
        return ctypes.CDLL(_SO)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _build_and_open()
    lib.ltpu_xxh32.restype = ctypes.c_uint32
    lib.ltpu_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_uint32]
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
    _lib = lib
    return lib


def xxh32(data: bytes, seed: int = 0) -> int:
    return _load().ltpu_xxh32(data, len(data), seed)


def decompress(src: bytes, max_out: int) -> bytes:
    """Scalar block-stream decode (Lizard_decompress_safe equivalent)."""
    dst = ctypes.create_string_buffer(max(max_out, 1))
    n = _load().ltpu_decompress(src, len(src), dst, max_out)
    if n < 0:
        raise CorruptError(f"native decompress failed ({n})")
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
