# Frozen copy of lizard_tpu_torch/format/constants.py at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea, with its imports
# pointing into h100_bench.reference. Later changes to the program do not reach it.
"""Lizard format constants, as pure data (a copy of
lizard_tpu/format/constants.py, which this package does not import).

Every value here is part of the on-wire format or of the reference encoder's
observable behavior. Citations point into the reference C
library's tree so parity can be audited:

- block constants:   lib/lizard_common.h:72-123, lib/lizard_compress.h:86-124
- frame constants:   lib/lizard_frame.c:117-124,192-201, doc/lizard_Frame_format.md
"""

# ---- core match/block constants (lib/lizard_common.h:72-86) ----
MINMATCH = 4
LIZARD_DICT_SIZE = 1 << 24          # 16 MB sliding window upper bound
WILDCOPYLENGTH = 16
LASTLITERALS = WILDCOPYLENGTH       # last 16 bytes of a block are literals
MFLIMIT = WILDCOPYLENGTH + MINMATCH  # last match must start 20 bytes before end
LIZARD_MIN_LENGTH = MFLIMIT + 1     # blocks shorter than 21 bytes: all literals
LIZARD_MAX_16BIT_OFFSET = 1 << 16
MM_LONGOFF = 16                     # min match length for offsets >= 1<<16
LIZARD_BLOCK_SIZE = 1 << 17         # 128 KB inner block (lizard_compress.h:122)
LIZARD_MAX_INPUT_SIZE = 0x7E000000  # lizard_compress.h:121

# ---- compression level range (lib/lizard_compress.h:86-92) ----
LIZARD_MIN_CLEVEL = 10
LIZARD_MAX_CLEVEL = 49
LIZARD_DEFAULT_CLEVEL = 17

# ---- LZ4-style codewords (lib/lizard_common.h:95-99) ----
ML_BITS_LZ4 = 4
ML_MASK_LZ4 = (1 << ML_BITS_LZ4) - 1    # 15
RUN_BITS_LZ4 = 8 - ML_BITS_LZ4          # 4
RUN_MASK_LZ4 = (1 << RUN_BITS_LZ4) - 1  # 15

# ---- LIZv1 codewords (lib/lizard_common.h:101-107) ----
ML_BITS_LIZ = 4
RUN_BITS_LIZ = 3
ML_RUN_BITS = ML_BITS_LIZ + RUN_BITS_LIZ  # 7
MAX_SHORT_LITLEN = 7
MAX_SHORT_MATCHLEN = 15
LIZARD_LAST_LONG_OFF = 31

# ---- block header byte flags (lib/lizard_common.h:109-115) ----
FLAG_LITERALS = 1
FLAG_FLAGS = 2
FLAG_OFFSET16 = 4
FLAG_OFFSET24 = 8
FLAG_LEN = 16
FLAG_UNCOMPRESSED = 128

# stream identifiers, in block serialization order len,off16,off24,flags,literals
# (lib/lizard_compress.c:206-222)
STREAM_ORDER = ("len", "off16", "off24", "flags", "literals")
STREAM_FLAG = {
    "literals": FLAG_LITERALS,
    "flags": FLAG_FLAGS,
    "off16": FLAG_OFFSET16,
    "off24": FLAG_OFFSET24,
    "len": FLAG_LEN,
}

# ---- encoder behavior constants ----
LIZARD_FAST_MIN_OFFSET = 8     # lib/lizard_parser_fast.h:1
SKIP_TRIGGER = 6               # lib/lizard_parser_fast.h:37
HASH_UPDATE_LIMIT = 8          # lib/lizard_compress.c:75
LIZARD_INIT_LAST_OFFSET = 0    # lib/lizard_common.h:82
LIZARD_OPT_NUM = 1 << 12       # lib/lizard_parser_optimal.h:6
REPMINMATCH = 1                # lib/lizard_parser_optimal.h:7

# Huffman gating (lib/lizard_compress.c:59-60,143; lizard_compress.c:374-377)
HUF_MIN_STREAM_LEN = 1024      # streams <= 1024 bytes are never Huffman-coded


def minimal_huff_gain(compr_size: int) -> int:
    """Huffman accepted only if this < original stream length
    (lib/lizard_compress.c:59)."""
    return compr_size + compr_size // 8 + 512


def minimal_block_gain(compr_size: int) -> int:
    """Compressed block kept only if this <= input size
    (lib/lizard_compress.c:60,228)."""
    return compr_size + compr_size // 32 + 512


def compress_bound(isize: int) -> int:
    """Worst-case compressed size (lib/lizard_compress.h:124)."""
    if isize > LIZARD_MAX_INPUT_SIZE:
        return 0
    return isize + 1 + 1 + (isize // LIZARD_BLOCK_SIZE + 1) * 4


# ---- hash function multipliers (lib/lizard_compress.c:76-97) ----
PRIME4 = 2654435761
PRIME5 = 889523592379
PRIME6 = 227718039650203
PRIME7 = 58295818150454627

# ---- frame format (doc/lizard_Frame_format.md, lib/lizard_frame.c) ----
LIZARDF_MAGIC = 0x184D2206
LIZARDF_MAGIC_SKIPPABLE_START = 0x184D2A50
LIZARDF_BLOCKUNCOMPRESSED_FLAG = 0x80000000
LIZARDF_VERSION = 1
# blockSizeID 1..7 -> bytes (lib/lizard_frame.c:192-201)
LIZARDF_BLOCK_SIZES = {
    1: 128 * 1024,
    2: 256 * 1024,
    3: 1024 * 1024,
    4: 4 * 1024 * 1024,
    5: 16 * 1024 * 1024,
    6: 64 * 1024 * 1024,
    7: 256 * 1024 * 1024,
}
LIZARDF_BLOCKSIZEID_DEFAULT = 1  # max128KB (lib/lizard_frame.c:120)

# ---- Huff0 / FSE constants (lib/entropy/huf.h, fse.h) ----
HUF_MAX_SYMBOL_VALUE = 255
HUF_DEFAULT_TABLELOG = 11
HUF_MAX_TABLELOG = 12
HUF_BLOCKSIZE_MAX = 128 * 1024
FSE_MAX_TABLELOG_FOR_HUFF_HEADER = 6
