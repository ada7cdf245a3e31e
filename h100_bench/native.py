"""The benchmark's own binding to its frozen copy of the native host runtime
(h100_bench/native/lizard_runtime.cpp, copied from native/ at commit
0be7bf655f3d0745fc3f06a33be719434c2ddeea): the encoder that makes the decode
cells' inputs, xxh32 for the frames the benchmark writes and checks, and
the frame decoder that checks every frame an encode cell returns. A later
change to the program's encoder or to native/ cannot change these.

Built at first use with tools/build_native.sh's flags into CACHE_DIR, a
fixed directory inside the checkout, under a lock, through a temporary file
renamed into place, so concurrent first runs never load half a library.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE_DIR = os.path.join(ROOT, ".cache", "h100_bench")
SRC = os.path.join(HERE, "native", "lizard_runtime.cpp")
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
_lib = None


def _path() -> str:
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(CACHE_DIR, "native", f"liblizard_bench-{h[:16]}.so")


def _open() -> ctypes.CDLL:
    so = _path()
    os.makedirs(os.path.dirname(so), exist_ok=True)
    with open(os.path.join(os.path.dirname(so), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++", *FLAGS, "-o", tmp, SRC]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr}")
            os.replace(tmp, so)
    return ctypes.CDLL(so)


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _open()
        lib.ltpu_compress.restype = ctypes.c_int64
        lib.ltpu_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int, ctypes.c_int]
        lib.ltpu_xxh32.restype = ctypes.c_uint32
        lib.ltpu_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_uint32]
        lib.ltpu_frame_decompress.restype = ctypes.c_int64
        lib.ltpu_frame_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t]
        _lib = lib
    return _lib


def compress(data: bytes, level: int) -> bytes:
    """A Lizard block stream of `data` at `level` (10-49)."""
    if not 10 <= level <= 49:
        raise ValueError(f"invalid level {level}")
    cap = len(data) + len(data) // 2 + 4096
    dst = ctypes.create_string_buffer(cap)
    n = lib().ltpu_compress(data, len(data), dst, cap, level, 1)
    if n < 0:
        raise RuntimeError(f"native compression failed ({n})")
    return dst.raw[:n]


def xxh32(data: bytes, seed: int = 0) -> int:
    return lib().ltpu_xxh32(data, len(data), seed)


def decompress_frame(src: bytes, max_out: int) -> bytes | None:
    """The content of a frame, or None when the frozen decoder refuses it
    (a bad block, checksum or size) or it would exceed max_out."""
    dst = ctypes.create_string_buffer(max(max_out, 1))
    n = lib().ltpu_frame_decompress(src, len(src), dst, max_out)
    return None if n < 0 else dst.raw[:n]
