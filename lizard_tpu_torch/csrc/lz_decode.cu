// lz_decode: LZ decode of post-entropy Lizard streams, both codeword
// families (fastLZ4 and LIZv1), on an H100 (sm_90a).
//
// Replaces three Pallas TPU kernels: lizard_tpu/ops/lane_decode.py::
// _lane_kernel (B1, launched by _lane_call), and the block decoders
// lizard_tpu/ops/pallas_decode.py::_lz4_block_kernel (B10, l.171) and
// _liz_block_kernel (B11, l.304), whose host side is
// lizard_tpu_torch/ops/pallas_decode.py. Their contract, not their tiling:
// the post-entropy streams (flags, literals, off16, off24) of a batch of
// inner blocks, grouped into chains (the consecutive inner blocks of one
// compressed stream or linked frame, which share one LZ77 window), decode to
// each chain's bytes (contiguous at the chain's base), each block's decoded
// length and a per-chain status. The family is per block (a linked chain may
// mix them).
//
// What bounds it on this card: the floor is the HBM traffic (the compressed
// streams read once, the decoded bytes written once, over 3.35 TB/s). What
// keeps a decoder far above it is the token parse: a dependent serial chain
// in which each token's stream positions depend on the previous token's
// lengths.
//
// What the design does about the serial parse: it makes the inner block, not
// the chain, the unit of work. Every inner block has its own five streams,
// and LIZv1's last_off resets at each block, so the parses of a chain's
// blocks are independent; only a match whose source lies before its block's
// start needs an earlier block's bytes. So:
//
// 1. pass1, one CTA per inner block (one per SM: the tile takes 144 KB).
//    The block's 128 KB output tile and a bitmap of its unresolved bytes live
//    in shared memory. Warp 0 parses the tokens 32 at a time, one a lane:
//    a token's stream positions are prefix sums of the lengths before it
//    (warp scans), up to the first token whose literal length has an
//    extension or whose match-length extension is longer than one byte,
//    which goes alone. (One token after another, a lone warp waits on the
//    latency of every dependent instruction of every token.) It writes one
//    sequence record a token into a ring in shared memory, a group at a
//    time; warp 1
//    executes the records in order, lane-parallel, literals from global
//    memory and match sources from the tile. A match that
//    reaches before the block's start is deferred: its bytes are marked
//    unresolved and (destination, offset, length) is stored in the block's
//    record list (one record per token at most, so the list is sized by the
//    flags stream). A later in-block match whose source touches an unresolved
//    byte is deferred the same way. The tile then goes to the block's slot
//    (chain base + i x 128 KB) in 16-byte stores, once.
// 2. scan, one warp per chain: block starts (prefix sums of the lengths),
//    the chain's status at the first failing block in chain order (a
//    deferred match whose source lies before the chain's start is an offset
//    error at its token, which comes before any later error of that block),
//    block_len = -1 from there on, and whether every non-final block is
//    full (then the slot layout is the contiguous layout).
// 3. link, one CTA per inner block with deferred copies: every deferred
//    byte gets the slot position of the byte it repeats (the copy's
//    source, offset mapped through the block starts of scan). This is the
//    one place where a cross-block offset meets the chain's layout.
// 4. jump, one CTA per such block: pointer jumping. While a byte's source
//    is itself unresolved, ptr[p] = ptr[ptr[p]]; every value ever stored is
//    a source of p, so the CTAs run in any order with no wait, and the
//    rounds are logarithmic in the length of the longest copy-of-a-copy
//    path (a first design walked the copies in order, one warp a block,
//    each waiting on the previous block's progress: the cascade of deferred
//    in-block matches made that serial). Then out[p] = out[ptr[p]], a
//    byte that pass1 wrote.
// 5. compact, one CTA per chain whose non-final block is short: the blocks
//    move from their slots to their contiguous positions, block by block
//    through shared memory. Every chain that the reference encoder writes is
//    full and skips this.
//
// Only a chain's non-first blocks can have deferred bytes to resolve (a
// first block's cross-block match is an offset error), so only they get
// pass-2 scratch: a 16 KB bitmap and 4 bytes of pointer per byte of the
// block (slot positions are 32-bit: a chain has at most 32768 blocks, 4 GiB,
// which the host checks), plus
// 12 bytes of record per flags byte of the batch. A batch of one-block
// chains (independent streams of at most 128 KB) takes no scratch and only
// launches 1 and 2.
//
// Semantics and corruption checks are those of the bit-exact oracle
// lizard_tpu/ref/block_decode.py (stricter only where the oracle would read
// past a stream's end), at the same first failing token in chain order. The
// kernels never read or write outside their tensors: the host validated the
// block table, every stream read is checked, each inner block's output is
// capped at LIZARD_BLOCK_SIZE in its slot. On corruption the chain's bytes
// are undefined and its status is set; the Python caller raises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockSize = 1 << 17;          // LIZARD_BLOCK_SIZE
constexpr int kBlockShift = 17;
constexpr int kBitWords = kBlockSize / 32;   // unresolved-byte bitmap words
constexpr int kRing = 512;                   // sequence records in flight
constexpr int kPass1Threads = 256;
constexpr int kPass1Smem = kBlockSize + kBitWords * 4;
constexpr int kScanWarps = 4;
constexpr int kCompactThreads = 256;
constexpr int kLinkThreads = 256;
constexpr int kJumpThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoReach = INT_MAX;

// status codes, shared with lizard_tpu_torch/ops/lane_decode.py
constexpr int kOk = 0;
constexpr int kErrLenExt = -1;
constexpr int kErrLiterals = -2;
constexpr int kErrOffset = -3;
constexpr int kErrOff16 = -4;
constexpr int kErrOff24 = -5;
constexpr int kErrRep0 = -6;
constexpr int kErrCapacity = -7;

// meta columns per block (pass1's result), shared with lane_decode.py
constexpr int kMeta = 5;
constexpr int kMetaStatus = 0;     // the block's own parse status
constexpr int kMetaReach = 1;      // min(dst - offset), cross-block matches
constexpr int kMetaDeferred = 2;   // deferred copies
constexpr int kMetaDeferredBytes = 3;
constexpr int kMetaRounds = 4;     // pointer-jumping rounds of jump

// chain info bits (scan's result)
constexpr int kChainShort = 1;     // a non-final block is short: compact
constexpr int kChainFailed = 2;

struct Rec {           // one token's sequence, in-block positions
  int lit;             // literal source, offset in the block's literals
  int nlit;
  int dst;             // where the literals go; the match follows them
  int off;
  int nmatch;          // 0: no match here (none, or deferred)
};

struct Streams {
  const uint8_t* fl;
  int64_t flen;
  const uint8_t* lit;
  int64_t iend;
  const uint8_t* o16;
  int64_t n16;
  const uint8_t* o24;
  int64_t n24;
};

__device__ __forceinline__ unsigned ldg8(const uint8_t* p) { return __ldg(p); }

// Length extension at lit[lp] (doc/lizard_Block_format.md:91-96): byte <254
// is the value; 254 -> LE16 follows; 255 -> LE24 follows. Every byte read
// lies before iend, else false.
__device__ __forceinline__ bool read_ext(const uint8_t* lit, int64_t& lp,
                                         int64_t iend, int64_t& value) {
  if (lp > iend - 1) return false;
  const unsigned first = ldg8(lit + lp);
  const int need = first < 254 ? 1 : (first == 254 ? 3 : 4);
  if (lp + need > iend) return false;
  if (first == 254) {
    value = ldg8(lit + lp + 1) | (ldg8(lit + lp + 2) << 8);
  } else if (first == 255) {
    value = ldg8(lit + lp + 1) | (ldg8(lit + lp + 2) << 8) |
            (ldg8(lit + lp + 3) << 16);
  } else {
    value = first;
  }
  lp += need;
  return true;
}

// The mask of bits [s, e) within word w (bit i of word w is byte 32w + i).
__device__ __forceinline__ uint32_t word_mask(int w, int s, int e) {
  uint32_t m = kFull;
  if (w == (s >> 5)) m &= kFull << (s & 31);
  if (w == ((e - 1) >> 5)) m &= kFull >> (31 - ((e - 1) & 31));
  return m;
}

// Whether any byte of [s, e) is marked, lanes over words (whole warp).
__device__ __forceinline__ bool any_marked(const uint32_t* bits, int s, int e,
                                           int lane) {
  bool any = false;
  for (int w = (s >> 5) + lane; w <= ((e - 1) >> 5); w += 32)
    any |= (bits[w] & word_mask(w, s, e)) != 0;
  return __any_sync(kFull, any);
}

// Literals from global memory and a match from the tile itself, in order,
// lane-parallel, four bytes in flight a lane. A match's source lies before
// its destination; an overlapping one (off < n) repeats its first off bytes.
__device__ __forceinline__ void execute(uint8_t* tile, const uint8_t* lit,
                                        const Rec& r, int lane) {
  for (int k0 = 0; k0 < r.nlit; k0 += 128) {
    uint8_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * 32 + lane;
      if (k < r.nlit) v[j] = ldg8(lit + r.lit + k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * 32 + lane;
      if (k < r.nlit) tile[r.dst + k] = v[j];
    }
  }
  __syncwarp(kFull);
  if (r.nmatch == 0) return;
  const int p = r.dst + r.nlit;
  const uint8_t* src = tile + p - r.off;
  uint8_t* dst = tile + p;
  if (r.off >= r.nmatch) {
    for (int k0 = 0; k0 < r.nmatch; k0 += 128) {
      uint8_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * 32 + lane;
        if (k < r.nmatch) v[j] = src[k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * 32 + lane;
        if (k < r.nmatch) dst[k] = v[j];
      }
    }
  } else {
    // dst[k] = src[k mod off], the remainder stepped, not divided
    const unsigned off = static_cast<unsigned>(r.off);
    const unsigned step = 32u % off;
    unsigned m = static_cast<unsigned>(lane) % off;
    for (unsigned k = lane; k < static_cast<unsigned>(r.nmatch); k += 32) {
      dst[k] = src[m];
      m += step;
      if (m >= off) m -= off;
    }
  }
  __syncwarp(kFull);
}

// The parser's state: warp 0, every lane holds the same values (the parse is
// redundant across lanes, its loads broadcast); lane 0 publishes.
struct Parser {
  uint8_t* tile;
  uint32_t* bits;
  Rec* ring;
  volatile int* head;
  volatile int* tail;
  int32_t* recs;            // this block's deferred-copy records, or null
  const uint8_t* lit;
  int lane;
  int op = 0;               // in-block output position
  int reach = kNoReach;
  int ndef = 0;
  int def_bytes = 0;
  int unres_lo = kBlockSize, unres_hi = 0;
  int h = 0;                // records published
  int tail_seen = 0;        // the copy warp's progress, as last read
  int64_t fbase = -128;     // flags fbase .. fbase + 63 held in the lanes'
  unsigned w0 = 0, w1 = 0;  // w0 (lane i: fbase + i) and w1 (fbase + 32 + i)

  // Make the window hold flags fp .. fp + 31.
  __device__ __forceinline__ void window(const Streams& s, int64_t fp) {
    if (fp < fbase || fp > fbase + 32) {
      fbase = fp;
      w0 = fp + lane < s.flen ? ldg8(s.fl + fp + lane) : 0;
      w1 = fp + 32 + lane < s.flen ? ldg8(s.fl + fp + 32 + lane) : 0;
    }
  }

  // Flag fp, in every lane.
  __device__ __forceinline__ unsigned flag(const Streams& s, int64_t fp) {
    window(s, fp);
    const int i = static_cast<int>(fp - fbase);
    return __shfl_sync(kFull, i < 32 ? w0 : w1, i & 31);
  }

  // Flag fp + lane in each lane (0 past the end).
  __device__ __forceinline__ unsigned lane_flag(const Streams& s, int64_t fp) {
    window(s, fp);
    const int i = static_cast<int>(fp - fbase) + lane;
    const unsigned a = __shfl_sync(kFull, w0, i & 31);
    const unsigned b = __shfl_sync(kFull, w1, i & 31);
    return i < 32 ? a : b;
  }

  // cnt records at once, record `r` from lane t < cnt, none deferred: one
  // ring publication.
  __device__ __forceinline__ void publish(const Rec& r, int cnt, int total) {
    if (lane == 0) {
      while (h + cnt - tail_seen > kRing) {
        tail_seen = *tail;
        if (h + cnt - tail_seen > kRing) __nanosleep(32);
      }
    }
    __syncwarp(kFull);
    if (lane < cnt) ring[(h + lane) & (kRing - 1)] = r;
    __syncwarp(kFull);
    if (lane == 0) {
      __threadfence_block();
      *head = h + cnt;
    }
    h += cnt;
    op += total;
  }

  // A cross-block match (its source before the block's start): its offset
  // is checked against the chain position in scan.
  __device__ __forceinline__ void cross(int d, int off) {
    if (d - off < 0 && d - off < reach) reach = d - off;
  }

  // One token: nlit literals from lit[lsrc] at op, then a match of n bytes
  // at offset off, executed here or in the copy warp, or deferred.
  __device__ __forceinline__ void sequence(int lsrc, int nlit, int off, int n) {
    const int d = op + nlit;
    const int end = d + n;
    if (n > 0) {
      const int s = d - off;
      bool defer = s < 0;
      if (!defer && ndef > 0) {
        const int e = s + min(off, n);
        defer = e > unres_lo && s < unres_hi && any_marked(bits, s, e, lane);
      }
      if (defer) {
        for (int w = (d >> 5) + lane; w <= ((d + n - 1) >> 5); w += 32)
          bits[w] |= word_mask(w, d, d + n);
        __syncwarp(kFull);
        if (lane == 0 && recs) {
          recs[ndef * 3 + 0] = d;
          recs[ndef * 3 + 1] = off;
          recs[ndef * 3 + 2] = n;
        }
        ++ndef;
        def_bytes += n;
        unres_lo = min(unres_lo, d);
        unres_hi = max(unres_hi, d + n);
        n = 0;
      }
    }
    if (lane == 0) {
      while (h - tail_seen >= kRing) {
        tail_seen = *tail;
        if (h - tail_seen >= kRing) __nanosleep(32);
      }
      ring[h & (kRing - 1)] = Rec{lsrc, nlit, op, off, n};
      __threadfence_block();
      *head = h + 1;
    }
    ++h;
    __syncwarp(kFull);
    op = end;
  }
};

// One fastLZ4 token (lizard_decompress_lz4.h; oracle _decode_block_lz4),
// in every lane. The LE16 offset and both length extensions come from the
// literals stream.
__device__ __forceinline__ int lz4_token(const Streams& b, Parser& P,
                                         int64_t& lp, unsigned token) {
  const int64_t iend = b.iend;
  int64_t length = token & 15;
  if (length == 15) {
    int64_t ext;
    if (lp > iend - 5 || !read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
    length += ext;
  }
  if (lp + length > iend - (2 + 16)) return kErrLiterals;
  if (P.op + length > kBlockSize) return kErrCapacity;
  const int lsrc = static_cast<int>(lp);
  const int nlit = static_cast<int>(length);
  lp += length;
  const int off = ldg8(b.lit + lp) | (ldg8(b.lit + lp + 1) << 8);
  lp += 2;
  if (off == 0) return kErrOffset;
  P.cross(P.op + nlit, off);
  length = token >> 4;
  if (length == 15) {
    int64_t ext;
    if (lp > iend - 5 || !read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
    length += ext;
  }
  length += 4;  // MINMATCH
  if (P.op + nlit + length > kBlockSize) return kErrCapacity;
  P.sequence(lsrc, nlit, off, static_cast<int>(length));
  return kOk;
}

__device__ __forceinline__ int warp_scan(int v, int lane) {  // inclusive
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// The fastLZ4 token loop, 32 tokens at a time: lane t parses token fp + t.
// A token's literals start where the previous token's fields end, which a
// prefix sum gives as long as no literal length has an extension (its value
// moves every later position) and every match-length extension is one byte;
// the group ends before the first token that breaks this, which then goes
// alone (lz4_token). The checks run per lane in the serial order, and the
// first failing lane is the block's status.
__device__ int parse_lz4(const Streams& b, Parser& P) {
  const int64_t iend = b.iend;
  const int lane = P.lane;
  int64_t lp = 0;
  int64_t fp = 0;
  while (fp < b.flen) {
    const bool valid = fp + lane < b.flen;
    const unsigned token = P.lane_flag(b, fp);
    const int ll = token & 15, mc = token >> 4;
    unsigned stop = __ballot_sync(kFull, !valid || ll == 15);
    int g = stop ? __ffs(stop) - 1 : 32;
    // literal positions, a one-byte match-length extension assumed
    const int adv = lane < g ? ll + 2 + (mc == 15) : 0;
    const int incl = warp_scan(adv, lane);
    const int64_t lpt = lp + incl - adv;        // this token's literals
    const int64_t q = lpt + ll;                 // its offset
    int code = kOk, off = 0, mlen = mc + 4;
    bool one_byte = true;
    if (lane < g) {
      if (lpt + ll > iend - (2 + 16)) {
        code = kErrLiterals;
      } else {
        off = ldg8(b.lit + q) | (ldg8(b.lit + q + 1) << 8);
        if (mc == 15) {
          if (q + 2 > iend - 5) {
            code = kErrLenExt;  // after the offset check, below
          } else {
            const unsigned x = ldg8(b.lit + q + 2);
            one_byte = x < 254;
            mlen += x;
          }
        }
      }
    }
    stop = __ballot_sync(kFull, lane < g && !one_byte);
    if (stop) g = min(g, __ffs(stop) - 1);
    if (g == 0) {  // the first token goes alone
      const int st = lz4_token(b, P, lp, P.flag(b, fp));
      if (st != kOk) return st;
      ++fp;
      continue;
    }
    const int len = lane < g ? ll + mlen : 0;
    const int ot = P.op + warp_scan(len, lane) - len;  // this token's output
    // the checks of lz4_token, in its order
    bool reach = false;
    if (lane < g && code != kErrLiterals) {
      if (ot + ll > kBlockSize) {
        code = kErrCapacity;
      } else if (off == 0) {
        code = kErrOffset;
      } else {
        reach = ot + ll - off < 0;            // a cross-block match
        if (code == kOk && ot + ll + mlen > kBlockSize) code = kErrCapacity;
      }
    }
    const unsigned bad = __ballot_sync(kFull, lane < g && code != kOk);
    const int e = bad ? __ffs(bad) - 1 : g;   // lanes before e are clean
    const int r = __reduce_min_sync(
        kFull, reach && lane <= e ? ot + ll - off : kNoReach);
    if (r < P.reach) P.reach = r;
    if (bad) return __shfl_sync(kFull, code, e);
    if (P.ndef == 0 && !__any_sync(kFull, reach)) {  // nothing to defer
      const int end = __shfl_sync(kFull, ot + len, g - 1);
      P.publish(Rec{static_cast<int>(lpt), ll, ot, off, mlen}, g,
                end - P.op);
    } else {
      for (int t = 0; t < g; ++t)  // deferral decisions, one at a time
        P.sequence(__shfl_sync(kFull, static_cast<int>(lpt), t),
                   __shfl_sync(kFull, ll, t), __shfl_sync(kFull, off, t),
                   __shfl_sync(kFull, mlen, t));
    }
    lp += __shfl_sync(kFull, incl, g - 1);
    fp += g;
  }
  const int64_t n = iend - lp;  // last literals
  if (P.op + n > kBlockSize) return kErrCapacity;
  P.sequence(static_cast<int>(lp), static_cast<int>(n), 0, 0);
  return kOk;
}

// One LIZv1 token (lizard_decompress_liz.h; oracle _decode_block_liz), in
// every lane. last_off resets at every inner block; the window does not.
__device__ __forceinline__ int liz_token(const Streams& b, Parser& P,
                                         int64_t& lp, int64_t& p16,
                                         int64_t& p24, int& last_off,
                                         unsigned token) {
  const int64_t iend = b.iend;
  int64_t length;
  int lsrc = static_cast<int>(lp), nlit = 0;
  if (token >= 32) {
    // [F_MMMM_LLL]: up to 7 literals, then a new off16 or the rep offset
    length = token & 7;
    if (length == 7) {
      int64_t ext;
      if (!read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
      length += ext;
    }
    if (lp > iend - 16 || lp + length > iend) return kErrLiterals;
    if (P.op + length > kBlockSize) return kErrCapacity;
    lsrc = static_cast<int>(lp);
    nlit = static_cast<int>(length);
    lp += length;
    if ((token >> 7) == 0) {
      if (p16 + 2 > b.n16) return kErrOff16;
      last_off = ldg8(b.o16 + p16) | (ldg8(b.o16 + p16 + 1) << 8);
      p16 += 2;
    }
    length = (token >> 3) & 15;
    if (length == 15) {
      int64_t ext;
      if (!read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
      length += ext;
    }
  } else {
    if (token < 31) {
      length = token + 16;  // MM_LONGOFF
    } else {
      // token 31: the length extension comes before the off24
      int64_t ext;
      if (!read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
      length = ext + 31 + 16;
    }
    if (p24 > b.n24 - 3) return kErrOff24;
    last_off = ldg8(b.o24 + p24) | (ldg8(b.o24 + p24 + 1) << 8) |
               (ldg8(b.o24 + p24 + 2) << 16);
    p24 += 3;
  }
  if (last_off == 0) {
    if (length != 0) return kErrRep0;  // only an empty rep match is legal
  } else {
    P.cross(P.op + nlit, last_off);
  }
  if (P.op + nlit + length > kBlockSize) return kErrCapacity;
  P.sequence(lsrc, nlit, last_off, static_cast<int>(length));
  return kOk;
}

// The LIZv1 token loop, 32 tokens at a time, as parse_lz4: the literals,
// off16 and off24 positions are prefix sums while no literal length has an
// extension and every match-length extension is one byte; a token's offset
// is that of the last token at or before it that reads one (a prefix max
// of lane indices), else the offset carried in from the previous group.
__device__ int parse_liz(const Streams& b, Parser& P) {
  const int64_t iend = b.iend;
  const int lane = P.lane;
  int64_t lp = 0, p16 = 0, p24 = 0, fp = 0;
  int last_off = 0;
  while (fp < b.flen) {
    const bool valid = fp + lane < b.flen;
    const unsigned tok = P.lane_flag(b, fp);
    const bool lit_tok = tok >= 32;
    const int ll = lit_tok ? tok & 7 : 0;
    const int mc = (tok >> 3) & 15;
    unsigned stop = __ballot_sync(kFull, !valid || (lit_tok && ll == 7));
    int g = stop ? __ffs(stop) - 1 : 32;
    const bool in = lane < g;
    const bool new16 = in && lit_tok && (tok >> 7) == 0;
    const bool new24 = in && !lit_tok;
    const bool ext = in && (lit_tok ? mc == 15 : tok == 31);
    // positions, a one-byte match-length extension assumed
    const int a_lp = in ? ll + ext : 0, a16 = new16 ? 2 : 0,
              a24 = new24 ? 3 : 0;
    const int i_lp = warp_scan(a_lp, lane), i16 = warp_scan(a16, lane),
              i24 = warp_scan(a24, lane);
    const int64_t lpt = lp + i_lp - a_lp, p16t = p16 + i16 - a16,
                  p24t = p24 + i24 - a24;
    const int64_t q = lpt + ll;  // the extension byte, if any
    int off = 0;
    unsigned x = 0;
    if (new16 && p16t + 2 <= b.n16)
      off = ldg8(b.o16 + p16t) | (ldg8(b.o16 + p16t + 1) << 8);
    if (new24 && p24t <= b.n24 - 3)
      off = ldg8(b.o24 + p24t) | (ldg8(b.o24 + p24t + 1) << 8) |
            (ldg8(b.o24 + p24t + 2) << 16);
    const bool ext_ok = q <= iend - 1;
    if (ext && ext_ok) x = ldg8(b.lit + q);
    stop = __ballot_sync(kFull, ext && ext_ok && x >= 254);
    if (stop) g = min(g, __ffs(stop) - 1);
    if (g == 0) {  // the first token goes alone
      const int st = liz_token(b, P, lp, p16, p24, last_off, P.flag(b, fp));
      if (st != kOk) return st;
      ++fp;
      continue;
    }
    const int mlen = lit_tok ? mc + (ext ? x : 0)
                             : (tok < 31 ? tok + 16 : x + 31 + 16);
    const int len = lane < g ? ll + mlen : 0;
    const int ot = P.op + warp_scan(len, lane) - len;
    int src = lane < g && (new16 || new24) ? lane : -1;  // prefix max
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      src = max(src, __shfl_up_sync(kFull, src, d) | (lane >= d ? 0 : -1));
    const int from = __shfl_sync(kFull, off, src < 0 ? 0 : src);
    const int lo = src < 0 ? last_off : from;  // this token's offset
    // the checks of liz_token, in its order
    int code = kOk;
    bool reached = false;
    if (lane < g) {
      if (lit_tok) {
        if (lpt > iend - 16 || lpt + ll > iend) code = kErrLiterals;
        else if (ot + ll > kBlockSize) code = kErrCapacity;
        else if (new16 && p16t + 2 > b.n16) code = kErrOff16;
        else if (ext && !ext_ok) code = kErrLenExt;
      } else {
        if (ext && !ext_ok) code = kErrLenExt;
        else if (p24t > b.n24 - 3) code = kErrOff24;
      }
      if (code == kOk) {
        if (lo == 0) {
          if (mlen != 0) code = kErrRep0;
        } else {
          reached = true;
        }
        if (code == kOk && ot + ll + mlen > kBlockSize) code = kErrCapacity;
      }
    }
    const bool cross = reached && ot + ll - lo < 0;
    const unsigned bad = __ballot_sync(kFull, lane < g && code != kOk);
    const int e = bad ? __ffs(bad) - 1 : g;
    const int r = __reduce_min_sync(kFull,
                                    cross && lane <= e ? ot + ll - lo : kNoReach);
    if (r < P.reach) P.reach = r;
    if (bad) return __shfl_sync(kFull, code, e);
    if (P.ndef == 0 && !__any_sync(kFull, cross)) {  // nothing to defer
      const int end = __shfl_sync(kFull, ot + len, g - 1);
      P.publish(Rec{static_cast<int>(lpt), ll, ot, lo, mlen}, g, end - P.op);
    } else {
      for (int t = 0; t < g; ++t)  // deferral decisions, one at a time
        P.sequence(__shfl_sync(kFull, static_cast<int>(lpt), t),
                   __shfl_sync(kFull, ll, t), __shfl_sync(kFull, lo, t),
                   __shfl_sync(kFull, mlen, t));
    }
    lp += __shfl_sync(kFull, i_lp, g - 1);
    p16 += __shfl_sync(kFull, i16, g - 1);
    p24 += __shfl_sync(kFull, i24, g - 1);
    last_off = __shfl_sync(kFull, lo, g - 1);
    fp += g;
  }
  const int64_t n = iend - lp;  // last literals
  if (P.op + n > kBlockSize) return kErrCapacity;
  P.sequence(static_cast<int>(lp), static_cast<int>(n), 0, 0);
  return kOk;
}

// The chain holding block b: the last row whose first block is <= b (rows
// in block order, as lane_decode.chain_table gives them), or -1.
__device__ __forceinline__ int64_t chain_of(const int64_t* chains,
                                            int64_t n_chains, int64_t b) {
  int64_t lo = 0, hi = n_chains - 1, c = -1;
  while (lo <= hi) {
    const int64_t mid = (lo + hi) / 2;
    if (chains[mid * 3] <= b) {
      c = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  if (c >= 0 && b >= chains[c * 3] + chains[c * 3 + 1]) c = -1;
  return c;
}

// The pass-2 scratch (unresolved-byte bitmap, pointers) of block b of chain
// c. Only a chain's non-first blocks have one (a first block's deferred
// copy is an offset error), numbered in block order: for chain_table's rows
// (disjoint runs in block order) b - c - 1 lies below n_blocks - n_chains.
__device__ __forceinline__ int64_t scratch_of(int64_t b, int64_t c) {
  return b - c - 1;
}

// blocks: (n_blocks, 8) int64 rows flags_off, flags_len, lit_off, lit_len,
// off16_off, off16_len, off24_off, off24_len. chains: (n_chains, 3) int64
// rows first block, block count, output base. family: per block (0 fastLZ4,
// 1 LIZv1), or null for every block `family0`. recs and bitmaps are null
// when no chain has a second block (n_scratch 0).
__global__ void __launch_bounds__(kPass1Threads, 1)
pass1(const uint8_t* __restrict__ flags, const uint8_t* __restrict__ literals,
      const uint8_t* __restrict__ off16, const uint8_t* __restrict__ off24,
      const int64_t* __restrict__ blocks, const int64_t* __restrict__ chains,
      int64_t n_chains, const uint8_t* __restrict__ family, int family0,
      uint8_t* out_all, int32_t* __restrict__ block_len,
      int32_t* __restrict__ meta, int32_t* __restrict__ recs,
      uint32_t* __restrict__ bitmaps, int64_t n_scratch,
      int32_t* __restrict__ bchain) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kBlockSize);
  __shared__ Rec ring[kRing];
  __shared__ int s_head, s_tail, s_done;
  __shared__ int s_out[5];  // len, status, reach, deferred, deferred bytes

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t c = chain_of(chains, n_chains, b);
  if (tid == 0) {
    bchain[b] = static_cast<int32_t>(c);
    if (c < 0) block_len[b] = -1;
    s_head = s_tail = s_done = 0;
  }
  if (c < 0) return;  // not in any chain: nothing to decode
  for (int w = tid; w < kBitWords; w += kPass1Threads) bits[w] = 0;
  __syncthreads();

  const int64_t* m = blocks + b * 8;
  const Streams s{flags + m[0], m[1], literals + m[2], m[3],
                  off16 + m[4], m[5], off24 + m[6], m[7]};
  if (warp == 0) {
    Parser P{tile, bits, ring, &s_head, &s_tail,
             recs ? recs + m[0] * 3 : nullptr, s.lit, lane};
    const int fam = family ? family[b] : family0;
    const int st = fam == 0 ? parse_lz4(s, P) : parse_liz(s, P);
    if (lane == 0) {
      s_out[0] = P.op;
      s_out[1] = st;
      s_out[2] = P.reach;
      s_out[3] = P.ndef;
      s_out[4] = P.def_bytes;
      __threadfence_block();
      *static_cast<volatile int*>(&s_done) = 1;
    }
  } else if (warp == 1) {
    volatile int* head = &s_head;
    volatile int* done = &s_done;
    int t = 0;
    for (;;) {
      int h = 0;
      if (lane == 0) {
        for (;;) {
          const int fin = *done;
          h = *head;
          if (h != t || fin) break;
          __nanosleep(32);
        }
      }
      h = __shfl_sync(kFull, h, 0);
      if (h == t) break;  // the parser is done and every record executed
      __threadfence_block();
      h = min(h, t + kRing / 2);
      for (; t < h; ++t) {
        const Rec r = ring[t & (kRing - 1)];  // registers: tile stores
        execute(tile, s.lit, r, lane);         // cannot alias it
      }
      if (lane == 0) *static_cast<volatile int*>(&s_tail) = t;
    }
  }
  __syncthreads();

  const int len = s_out[0], st = s_out[1];
  if (tid == 0) {
    block_len[b] = len;
    int32_t* mb = meta + b * kMeta;
    mb[kMetaStatus] = st;
    mb[kMetaReach] = s_out[2];
    mb[kMetaDeferred] = s_out[3];
    mb[kMetaDeferredBytes] = s_out[4];
    mb[kMetaRounds] = 0;
  }
  if (st != kOk) return;  // the chain's bytes are undefined
  uint8_t* slot = out_all + chains[c * 3 + 2] +
                  ((b - chains[c * 3]) << kBlockShift);
  if ((reinterpret_cast<uintptr_t>(slot) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(tile);
    uint4* dst = reinterpret_cast<uint4*>(slot);
    for (int v = tid; v < (len + 15) / 16; v += kPass1Threads) dst[v] = src[v];
  } else {
    for (int k = tid; k < len; k += kPass1Threads) slot[k] = tile[k];
  }
  const int64_t x = scratch_of(b, c);
  if (s_out[3] && b > chains[c * 3] && x < n_scratch) {
    uint32_t* gb = bitmaps + x * kBitWords;
    for (int w = tid; w < kBitWords; w += kPass1Threads) gb[w] = bits[w];
  }
}

// One warp per chain: block starts, status, block_len = -1 from the first
// failing block, and the chain's info bits.
__global__ void __launch_bounds__(kScanWarps * 32)
scan(const int64_t* __restrict__ chains, int64_t n_chains,
     int32_t* __restrict__ block_len, const int32_t* __restrict__ meta,
     int64_t* __restrict__ start, int32_t* __restrict__ status,
     int32_t* __restrict__ cinfo) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kScanWarps +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= n_chains) return;
  const int64_t first = chains[c * 3], count = chains[c * 3 + 1];
  int64_t S = 0, fail = -1;
  int code = kOk;
  bool is_short = false;
  for (int64_t i0 = 0; i0 < count; i0 += 32) {
    const int64_t i = i0 + lane;
    const bool v = i < count;
    const int64_t b = first + i;
    const int64_t len = v ? block_len[b] : 0;
    const int st = v ? meta[b * kMeta + kMetaStatus] : kOk;
    const int rc = v ? meta[b * kMeta + kMetaReach] : kNoReach;
    int64_t incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int64_t excl = S + incl - len;
    const bool reach_bad = v && rc != kNoReach && excl + rc < 0;
    const bool bad = v && (st != kOk || reach_bad);
    const unsigned mask = __ballot_sync(kFull, bad);
    const int f = mask ? __ffs(mask) - 1 : 32;
    if (v && lane <= f) start[b] = excl;
    if (__ballot_sync(kFull, v && lane < f && i < count - 1 &&
                                 len != kBlockSize))
      is_short = true;
    if (mask) {
      fail = i0 + f;
      code = __shfl_sync(kFull, reach_bad ? kErrOffset : st, f);
      break;
    }
    S += __shfl_sync(kFull, incl, 31);
  }
  if (fail >= 0)
    for (int64_t i = fail + lane; i < count; i += 32) block_len[first + i] = -1;
  if (lane == 0) {
    status[c] = code;
    cinfo[c] = (fail >= 0 ? kChainFailed : 0) | (is_short ? kChainShort : 0);
  }
}

// Chain position q -> its byte in the slot layout.
__device__ __forceinline__ int64_t slot_of(int64_t q, bool is_short,
                                           int64_t first, int64_t count,
                                           const int64_t* start) {
  if (!is_short) return q;
  int64_t lo = 0, hi = count - 1, k = 0;
  while (lo <= hi) {
    const int64_t mid = (lo + hi) / 2;
    if (start[first + mid] <= q) {
      k = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  return (k << kBlockShift) + q - start[first + k];
}

// Whether block b (of chain c) has deferred copies for pass 2 to resolve.
__device__ __forceinline__ bool has_pass2(int64_t b, int64_t c,
                                          const int64_t* chains,
                                          const int32_t* meta,
                                          const int32_t* cinfo,
                                          int64_t n_scratch) {
  return c >= 0 && meta[b * kMeta + kMetaDeferred] != 0 &&
         meta[b * kMeta + kMetaStatus] == kOk &&
         !(cinfo[c] & kChainFailed) &&  // else the chain's bytes are undefined
         b > chains[c * 3] && scratch_of(b, c) < n_scratch;
}

// One CTA per inner block with deferred copies, after scan: each deferred
// byte p of the copy (d, off, n) gets its source, the byte it repeats:
// ptr[p] = the slot position (chain-relative) of chain position
// S_b + d - off + (k mod off) for k = p - d. Copies need no order here.
// Slot positions are 32-bit: the host keeps chains under 2^32 bytes.
__global__ void __launch_bounds__(kLinkThreads)
link(const int64_t* __restrict__ blocks, const int64_t* __restrict__ chains,
     const int32_t* __restrict__ meta, const int32_t* __restrict__ recs,
     const int32_t* __restrict__ bchain, const int64_t* __restrict__ start,
     const int32_t* __restrict__ cinfo, uint32_t* __restrict__ ptr,
     int64_t n_scratch) {
  const int64_t b = blockIdx.x;
  const int64_t c = bchain[b];
  if (!has_pass2(b, c, chains, meta, cinfo, n_scratch)) return;
  const int nd = meta[b * kMeta + kMetaDeferred];
  const bool is_short = cinfo[c] & kChainShort;
  const int64_t first = chains[c * 3], count = chains[c * 3 + 1];
  const int64_t sb = start[b];
  const int32_t* r = recs + blocks[b * 8] * 3;
  uint32_t* mine = ptr + (scratch_of(b, c) << kBlockShift);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < nd; j += kLinkThreads / 32) {
    const int d = r[j * 3], off = r[j * 3 + 1], n = r[j * 3 + 2];
    const int64_t q0 = sb + d - off;
    for (int k = lane; k < n; k += 32)
      mine[d + k] = static_cast<uint32_t>(
          slot_of(q0 + (off < n ? k % off : k), is_short, first, count,
                  start));
  }
}

// Whether chain slot position s (of chain c, whose first block is `first`)
// is a byte that pass1 left unresolved. The first block has none: its
// deferred copy would have failed the chain.
__device__ __forceinline__ bool unresolved(uint32_t s, int64_t first,
                                           int64_t c, const int32_t* meta,
                                           const uint32_t* bitmaps) {
  const int64_t k = first + (s >> kBlockShift);
  if (k == first || meta[k * kMeta + kMetaDeferred] == 0) return false;
  const uint32_t w = __ldg(bitmaps + scratch_of(k, c) * kBitWords +
                           ((s & (kBlockSize - 1)) >> 5));
  return (w >> (s & 31)) & 1;
}

// One CTA per inner block with deferred copies: pointer jumping. While a
// deferred byte's source is itself unresolved, ptr[p] = ptr[ptr[p]] (each
// step at least halves what is left of the path, and every value ever
// stored is a source of p, so the CTAs need no order among them); then
// out[p] = out[ptr[p]], a byte that pass1 wrote.
__global__ void __launch_bounds__(kJumpThreads)
jump(const int64_t* __restrict__ chains, uint8_t* out_all,
     const int32_t* __restrict__ block_len, int32_t* meta,
     const uint32_t* __restrict__ bitmaps,
     const int32_t* __restrict__ bchain, const int32_t* __restrict__ cinfo,
     uint32_t* ptr, int64_t n_scratch) {
  __shared__ uint32_t bits[kBitWords];
  const int64_t b = blockIdx.x;
  const int64_t c = bchain[b];
  if (!has_pass2(b, c, chains, meta, cinfo, n_scratch)) return;
  const int64_t first = chains[c * 3];
  const int64_t x = scratch_of(b, c);
  const int tid = threadIdx.x;
  for (int w = tid; w < kBitWords; w += kJumpThreads)
    bits[w] = bitmaps[x * kBitWords + w];
  __syncthreads();
  const int len = block_len[b];
  uint32_t* mine = ptr + (x << kBlockShift);
  // chain slot position s (not in the first block) -> its pointer
  const int64_t chain_ptr = (first - c - 1) << kBlockShift;
  int rounds = 0;
  for (;;) {
    ++rounds;
    int changed = 0;
    for (int p = tid; p < len; p += kJumpThreads) {
      if (!((bits[p >> 5] >> (p & 31)) & 1)) continue;
      const uint32_t s = __ldcg(mine + p);
      if (unresolved(s, first, c, meta, bitmaps)) {
        mine[p] = __ldcg(ptr + (chain_ptr + s));
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  if (tid == 0) meta[b * kMeta + kMetaRounds] = rounds;
  uint8_t* base = out_all + chains[c * 3 + 2];
  uint8_t* dst = base + ((b - first) << kBlockShift);
  for (int p = tid; p < len; p += kJumpThreads)
    if ((bits[p >> 5] >> (p & 31)) & 1) dst[p] = base[__ldcg(mine + p)];
}

// One CTA per chain with a short non-final block: every block moves from its
// slot to its contiguous position, in order, through shared memory.
__global__ void __launch_bounds__(kCompactThreads)
compact(const int64_t* __restrict__ chains, uint8_t* out_all,
        const int32_t* __restrict__ block_len,
        const int64_t* __restrict__ start,
        const int32_t* __restrict__ cinfo) {
  extern __shared__ __align__(16) uint8_t buf[];
  const int64_t c = blockIdx.x;
  if (cinfo[c] != kChainShort) return;
  const int64_t first = chains[c * 3], count = chains[c * 3 + 1];
  uint8_t* base = out_all + chains[c * 3 + 2];
  const int tid = threadIdx.x;
  for (int64_t i = 1; i < count; ++i) {
    const int64_t s = start[first + i];
    const int len = block_len[first + i];
    if (s == (i << kBlockShift)) continue;
    const uint8_t* src = base + (i << kBlockShift);
    for (int k = tid; k < len; k += kCompactThreads) buf[k] = src[k];
    __syncthreads();
    for (int k = tid; k < len; k += kCompactThreads) base[s + k] = buf[k];
    __syncthreads();
  }
}

}  // namespace

// The launches on `stream`, no synchronisation; returns the first cudaError
// and sets *launched to the kernels launched. pass1 and scan always; link,
// jump and compact only when a chain has a second block (n_blocks >
// n_chains for chain_table's rows). Scratch (device memory, sized by the
// caller): meta (n_blocks x 5 int32), bchain (n_blocks int32), start
// (n_blocks int64), cinfo (n_chains int32); with n_scratch = n_blocks -
// n_chains > 0 also recs (3 int32 per flags byte), bitmaps (n_scratch x
// 4096 uint32) and ptr (n_scratch x LIZARD_BLOCK_SIZE uint32), else null.
extern "C" int lz_decode_launch(
    const uint8_t* flags, const uint8_t* literals, const uint8_t* off16,
    const uint8_t* off24, const int64_t* blocks, int64_t n_blocks,
    const int64_t* chains, int64_t n_chains, const uint8_t* family,
    int family0, uint8_t* out, int32_t* block_len, int32_t* status,
    int32_t* meta, int32_t* recs, uint32_t* bitmaps, int32_t* bchain,
    int64_t* start, int32_t* cinfo, uint32_t* ptr, int32_t* launched,
    void* stream) {
  *launched = 0;
  if (n_chains <= 0 || n_blocks <= 0) return 0;
  const int64_t n_scratch = n_blocks > n_chains ? n_blocks - n_chains : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, kPass1Smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(compact,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBlockSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  pass1<<<grid, kPass1Threads, kPass1Smem, s>>>(
      flags, literals, off16, off24, blocks, chains, n_chains, family,
      family0, out, block_len, meta, recs, bitmaps, n_scratch, bchain);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  scan<<<static_cast<unsigned>((n_chains + kScanWarps - 1) / kScanWarps),
         kScanWarps * 32, 0, s>>>(chains, n_chains, block_len, meta, start,
                                  status, cinfo);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  if (n_scratch == 0) return 0;  // no second block: nothing crosses blocks
  link<<<grid, kLinkThreads, 0, s>>>(blocks, chains, meta, recs, bchain,
                                     start, cinfo, ptr, n_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  jump<<<grid, kJumpThreads, 0, s>>>(chains, out, block_len, meta, bitmaps,
                                     bchain, cinfo, ptr, n_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  compact<<<static_cast<unsigned>(n_chains), kCompactThreads, kBlockSize, s>>>(
      chains, out, block_len, start, cinfo);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}
