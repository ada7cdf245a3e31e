"""xxHash-32 (seedable, one-shot and streaming), a copy of the xxh32 half of
lizard_tpu/utils/xxh.py.

Implemented from the public xxHash specification. Used for the frame-format
header checksum byte and content checksum (doc/lizard_Frame_format.md:92-100,
214-222). The frame code hashes through the native runtime
(lizard_tpu_torch.runtime.xxh32); this module is the specification oracle.
"""

M32 = 0xFFFFFFFF

P32_1 = 2654435761
P32_2 = 2246822519
P32_3 = 3266489917
P32_4 = 668265263
P32_5 = 374761393


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


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
