"""The host process's allocator policy, pinned before anything allocates.

glibc serves an allocation of at least its mmap threshold (128 KiB at
start) by a fresh mmap, whose pages fault in on first touch, and raises the
threshold as it frees such chunks. The program's readback returns one
bytes object of 128 KiB and a few bytes per block, just over the starting
threshold, so whether a run's answers reuse heap memory or fault in fresh
pages depended on the frees of its set-up: on the card, runs of one cell
read 0.33 or 0.75-0.87 GB/s with nothing else changed. Pinning both
thresholds (as a long-running process's dynamic threshold would settle)
makes every run take the same path.
"""

import ctypes

M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
MMAP_THRESHOLD = 32 << 20          # glibc's largest (64-bit)
TRIM_THRESHOLD = 256 << 20


def pin_malloc() -> bool:
    """Fix glibc's mmap and trim thresholds; False where there is no
    glibc mallopt."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    return bool(mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)
                and mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD))
