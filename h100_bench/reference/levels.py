# Frozen copy of lizard_tpu_torch/format/levels.py at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea, with its imports
# pointing into h100_bench.reference. Later changes to the program do not reach it.
"""The Lizard compression-level parameter table, as pure data (a copy of
lizard_tpu/format/levels.py).

This table is the reference's real configuration system: one row of 11
parameters per level (lib/lizard_common.h:234-284). The values below are the
on-disk-behavior-defining facts of the format (they select parser, codeword
family, window size, and search effort per level) and are reproduced
verbatim as data.
"""

import enum
from dataclasses import dataclass

from h100_bench.reference.constants import MM_LONGOFF


class Parser(enum.Enum):
    FAST_SMALL = "fastSmall"
    FAST = "fast"
    FAST_BIG = "fastBig"
    NO_CHAIN = "noChain"
    HASH_CHAIN = "hashChain"
    PRICE_FAST = "priceFast"
    LOWEST_PRICE = "lowestPrice"
    OPTIMAL_PRICE = "optimalPrice"
    OPTIMAL_PRICE_BT = "optimalPriceBT"


class Codewords(enum.Enum):
    LZ4 = "LZ4"
    LIZv1 = "LIZv1"


@dataclass(frozen=True)
class LevelParams:
    window_log: int
    content_log: int
    hash_log: int
    hash_log3: int
    search_num: int
    search_length: int
    mm_long_off: int
    sufficient_length: int
    full_search: int
    parser: Parser
    codewords: Codewords

    @property
    def uses_huffman(self) -> bool:
        # levels >= 30 huffman-code flags+literals (lizard_compress.c:374-377)
        return False  # patched per-level below


# shorthand
_W4 = 16   # LIZARD_WINDOWLOG_LZ4
_C4 = 16   # LIZARD_CHAINLOG_LZ4
_H4 = 18   # LIZARD_HASHLOG_LZ4
_H4S = 12  # LIZARD_HASHLOG_LZ4SM
_W1 = 22   # LIZARD_WINDOWLOG_LIZv1
_C1 = 22   # LIZARD_CHAINLOG_LIZv1
_H1 = 18   # LIZARD_HASHLOG_LIZv1
_MM = MM_LONGOFF

P = Parser
C = Codewords

# level -> row of lib/lizard_common.h:234-284
LEVELS: dict[int, LevelParams] = {
    10: LevelParams(_W4, 0,      _H4S, 0,  0,     0, 0,   0,     0, P.FAST_SMALL,       C.LZ4),
    11: LevelParams(_W4, 0,      _H4,  0,  0,     0, 0,   0,     0, P.FAST,             C.LZ4),
    12: LevelParams(_W4, 0,      _H4,  0,  0,     0, 0,   0,     0, P.NO_CHAIN,         C.LZ4),
    13: LevelParams(_W4, _C4,    _H4,  0,  2,     5, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    14: LevelParams(_W4, _C4,    _H4,  0,  4,     5, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    15: LevelParams(_W4, _C4,    _H4,  0,  8,     5, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    16: LevelParams(_W4, _C4,    _H4,  0,  16,    4, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    17: LevelParams(_W4, _C4,    _H4,  0,  256,   4, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    18: LevelParams(_W4, _W4+1,  _H4,  16, 16,    4, 0,   1<<10, 1, P.OPTIMAL_PRICE_BT, C.LZ4),
    19: LevelParams(_W4, _W4+1,  23,   16, 256,   4, 0,   1<<10, 1, P.OPTIMAL_PRICE_BT, C.LZ4),
    20: LevelParams(_W1, 0,      14,   0,  1,     5, _MM, 0,     0, P.FAST_BIG,         C.LIZv1),
    21: LevelParams(_W1, _C1,    14,   13, 1,     5, _MM, 0,     0, P.PRICE_FAST,       C.LIZv1),
    22: LevelParams(_W1, _C1,    _H1,  13, 1,     5, _MM, 0,     0, P.PRICE_FAST,       C.LIZv1),
    23: LevelParams(_W1, _C1,    _H1,  13, 1,     5, _MM, 64,    0, P.LOWEST_PRICE,     C.LIZv1),
    24: LevelParams(_W1, _C1,    23,   16, 2,     5, _MM, 64,    0, P.LOWEST_PRICE,     C.LIZv1),
    25: LevelParams(_W1, _C1,    23,   16, 8,     4, _MM, 64,    0, P.LOWEST_PRICE,     C.LIZv1),
    26: LevelParams(_W1, _C1+1,  23,   16, 8,     4, _MM, 64,    1, P.OPTIMAL_PRICE_BT, C.LIZv1),
    27: LevelParams(_W1, _C1+1,  23,   16, 128,   4, _MM, 64,    1, P.OPTIMAL_PRICE_BT, C.LIZv1),
    28: LevelParams(_W1, _C1+1,  23,   24, 1<<10, 4, _MM, 1<<10, 1, P.OPTIMAL_PRICE_BT, C.LIZv1),
    29: LevelParams(24,  25,     23,   24, 1<<10, 4, _MM, 1<<10, 1, P.OPTIMAL_PRICE_BT, C.LIZv1),
    30: LevelParams(_W4, 0,      _H4S, 0,  0,     0, 0,   0,     0, P.FAST_SMALL,       C.LZ4),
    31: LevelParams(_W4, 0,      _H4,  0,  0,     0, 0,   0,     0, P.FAST,             C.LZ4),
    32: LevelParams(_W4, 0,      14,   0,  0,     0, 0,   0,     0, P.NO_CHAIN,         C.LZ4),
    33: LevelParams(_W4, 0,      _H4,  0,  0,     0, 0,   0,     0, P.NO_CHAIN,         C.LZ4),
    34: LevelParams(_W4, _C4,    _H4,  0,  2,     5, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    35: LevelParams(_W4, _C4,    _H4,  0,  4,     5, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    36: LevelParams(_W4, _C4,    _H4,  0,  8,     5, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    37: LevelParams(_W4, _C4,    _H4,  0,  16,    4, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    38: LevelParams(_W4, _C4,    _H4,  0,  256,   4, 0,   0,     0, P.HASH_CHAIN,       C.LZ4),
    39: LevelParams(_W4, _W4+1,  23,   16, 256,   4, 0,   1<<10, 1, P.OPTIMAL_PRICE_BT, C.LZ4),
    40: LevelParams(_W1, 0,      14,   0,  1,     5, _MM, 0,     0, P.FAST_BIG,         C.LIZv1),
    41: LevelParams(_W1, _C1,    14,   13, 1,     5, _MM, 0,     0, P.PRICE_FAST,       C.LIZv1),
    42: LevelParams(_W1, _C1,    _H1,  13, 1,     5, _MM, 0,     0, P.PRICE_FAST,       C.LIZv1),
    43: LevelParams(_W1, _C1,    _H1,  13, 1,     5, _MM, 64,    0, P.LOWEST_PRICE,     C.LIZv1),
    44: LevelParams(_W1, _C1,    23,   16, 2,     5, _MM, 64,    0, P.LOWEST_PRICE,     C.LIZv1),
    45: LevelParams(_W1, _C1,    23,   16, 8,     4, _MM, 64,    0, P.LOWEST_PRICE,     C.LIZv1),
    46: LevelParams(_W1, _C1,    23,   16, 8,     4, _MM, 64,    0, P.OPTIMAL_PRICE,    C.LIZv1),
    47: LevelParams(_W1, _C1+1,  23,   16, 8,     4, _MM, 64,    1, P.OPTIMAL_PRICE_BT, C.LIZv1),
    48: LevelParams(_W1, _C1+1,  23,   16, 128,   4, _MM, 64,    1, P.OPTIMAL_PRICE_BT, C.LIZv1),
    49: LevelParams(24,  25,     23,   24, 1<<10, 4, _MM, 1<<10, 1, P.OPTIMAL_PRICE_BT, C.LIZv1),
}


def uses_huffman(level: int) -> bool:
    """Levels >= 30 Huffman-code the flags+literals streams
    (lib/lizard_compress.c:374-377)."""
    return level >= 30


def validate_level(level: int) -> int:
    """Clamp semantics of Lizard_verifyCompressionLevel
    (lib/lizard_compress.c:303-308)."""
    from h100_bench.reference.constants import (
        LIZARD_DEFAULT_CLEVEL,
        LIZARD_MAX_CLEVEL,
        LIZARD_MIN_CLEVEL,
    )
    if level > LIZARD_MAX_CLEVEL:
        return LIZARD_MAX_CLEVEL
    if level < LIZARD_MIN_CLEVEL:
        return LIZARD_DEFAULT_CLEVEL
    return level
