"""xxHash-32 (seedable, one-shot and streaming) and xxHash-64 (one-shot), a
copy of lizard_tpu/utils/xxh.py.

Implemented from the public xxHash specification. xxh32 makes the
frame-format header checksum byte and content checksum
(doc/lizard_Frame_format.md:92-100, 214-222); the reference's round-trip
checks use XXH64 (programs/bench.c:293-317). The frame code hashes through
the native runtime (lizard_tpu_torch.runtime.xxh32, .xxh64); this module is
the specification oracle.
"""

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF

P32_1 = 2654435761
P32_2 = 2246822519
P32_3 = 3266489917
P32_4 = 668265263
P32_5 = 374761393

P64_1 = 11400714785074694791
P64_2 = 14029467366897019727
P64_3 = 1609587929392839161
P64_4 = 9650029242287828579
P64_5 = 2870177450012600261


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round32(acc: int, lane: int) -> int:
    return (_rotl32((acc + lane * P32_2) & M32, 13) * P32_1) & M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    if n >= 16:
        v1 = (seed + P32_1 + P32_2) & M32
        v2 = (seed + P32_2) & M32
        v3 = seed & M32
        v4 = (seed - P32_1) & M32
        nstripes = n // 16
        try:
            import numpy as np
            words = np.frombuffer(data[: nstripes * 16], dtype="<u4").reshape(nstripes, 4)
            # per-lane sequential fold (cheap in Python only for short inputs;
            # numpy just does the byte->word decode)
            w = words.tolist()
        except Exception:
            import struct
            w = [struct.unpack_from("<4I", data, i * 16) for i in range(nstripes)]
        for s in w:
            v1 = _round32(v1, s[0])
            v2 = _round32(v2, s[1])
            v3 = _round32(v3, s[2])
            v4 = _round32(v4, s[3])
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & M32
        p = nstripes * 16
    else:
        h = (seed + P32_5) & M32
        p = 0

    h = (h + n) & M32
    while p + 4 <= n:
        h = (h + int.from_bytes(data[p:p + 4], "little") * P32_3) & M32
        h = (_rotl32(h, 17) * P32_4) & M32
        p += 4
    while p < n:
        h = (h + data[p] * P32_5) & M32
        h = (_rotl32(h, 11) * P32_1) & M32
        p += 1

    h ^= h >> 15
    h = (h * P32_2) & M32
    h ^= h >> 13
    h = (h * P32_3) & M32
    h ^= h >> 16
    return h


def _round64(acc: int, lane: int) -> int:
    return (_rotl64((acc + lane * P64_2) & M64, 31) * P64_1) & M64


def _merge64(acc: int, val: int) -> int:
    acc ^= _round64(0, val)
    return (acc * P64_1 + P64_4) & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    if n >= 32:
        v1 = (seed + P64_1 + P64_2) & M64
        v2 = (seed + P64_2) & M64
        v3 = seed & M64
        v4 = (seed - P64_1) & M64
        nstripes = n // 32
        import struct
        for i in range(nstripes):
            s = struct.unpack_from("<4Q", data, i * 32)
            v1 = _round64(v1, s[0])
            v2 = _round64(v2, s[1])
            v3 = _round64(v3, s[2])
            v4 = _round64(v4, s[3])
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & M64
        h = _merge64(h, v1)
        h = _merge64(h, v2)
        h = _merge64(h, v3)
        h = _merge64(h, v4)
        p = nstripes * 32
    else:
        h = (seed + P64_5) & M64
        p = 0

    h = (h + n) & M64
    while p + 8 <= n:
        h ^= _round64(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl64(h, 27) * P64_1 + P64_4) & M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * P64_1) & M64
        h = (_rotl64(h, 23) * P64_2 + P64_3) & M64
        p += 4
    while p < n:
        h ^= (data[p] * P64_5) & M64
        h = (_rotl64(h, 11) * P64_1) & M64
        p += 1

    h ^= h >> 33
    h = (h * P64_2) & M64
    h ^= h >> 29
    h = (h * P64_3) & M64
    h ^= h >> 32
    return h


class XXH32:
    """Streaming XXH32 (frame layer hashes content incrementally)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.buf = b""
        self.total = 0
        self.v = [
            (seed + P32_1 + P32_2) & M32,
            (seed + P32_2) & M32,
            seed & M32,
            (seed - P32_1) & M32,
        ]

    def update(self, data: bytes) -> "XXH32":
        self.total += len(data)
        data = self.buf + data
        nstripes = len(data) // 16
        v1, v2, v3, v4 = self.v
        for i in range(nstripes):
            base = i * 16
            v1 = _round32(v1, int.from_bytes(data[base:base + 4], "little"))
            v2 = _round32(v2, int.from_bytes(data[base + 4:base + 8], "little"))
            v3 = _round32(v3, int.from_bytes(data[base + 8:base + 12], "little"))
            v4 = _round32(v4, int.from_bytes(data[base + 12:base + 16], "little"))
        self.v = [v1, v2, v3, v4]
        self.buf = data[nstripes * 16:]
        return self

    def digest(self) -> int:
        v1, v2, v3, v4 = self.v
        if self.total >= 16:
            h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & M32
        else:
            h = (self.seed + P32_5) & M32
        h = (h + self.total) & M32
        data, p, n = self.buf, 0, len(self.buf)
        while p + 4 <= n:
            h = (h + int.from_bytes(data[p:p + 4], "little") * P32_3) & M32
            h = (_rotl32(h, 17) * P32_4) & M32
            p += 4
        while p < n:
            h = (h + data[p] * P32_5) & M32
            h = (_rotl32(h, 11) * P32_1) & M32
            p += 1
        h ^= h >> 15
        h = (h * P32_2) & M32
        h ^= h >> 13
        h = (h * P32_3) & M32
        h ^= h >> 16
        return h
