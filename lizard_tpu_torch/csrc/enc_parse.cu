// enc_parse: the device encoder's parse, on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel lizard_tpu/ops/enc_lanes.py::_pA_kernel
// (l.762, launched by pA_call l.1176). Its contract, not its tiling, is the
// numpy mirror p2_reference (l.1733): per block of len >= 21 bytes, with
// lim = len - 16 and a cursor from 0,
// - s: the next position >= cursor with a candidate in ANY of the ncand maps
//   (map 0 may be empty where another is not);
// - pick(s): each map with a candidate d at s (the far map, the last one
//   when `far`, holds raw = d - (far_dist-1)) is extended to x, its first
//   4-byte word mismatch at or after s (lim if none before lim); its length
//   is ml = min(x - s + 3, lim - s) (lim - s at x >= lim) and its visible
//   length v = seg_end - s + 3 when x >= seg_end (the segment of s), else
//   ml; a far candidate with v < 16 is dropped; the strictly longest v wins,
//   so the earlier map wins ties. No candidate left: cursor = s + 1;
// - lazy steps 1..lazy, only while s0 % 128 < 128 - step: the pick at
//   s0 + step (with s0's seg_end) takes over if v2 > v1 + (s0 + step - s);
// - back-extension: while bk > max(cursor, d, segment start of s) and the
//   bytes before bk and bk - d are equal, bk -= 1;
// - token (bk, ml + s - bk, d); cursor = s + ml.
// Every token advances the cursor by >= 4 bytes on match_find's maps, so
// n/4 + 1 slots suffice; there is no token cap, no iteration cap and no
// overflow fallback. A block that would exceed its slots (only possible on
// maps with candidates at or past lim) gets count -1.
//
// What bounds it on this card: bytes, at the floor: the block and its ncand
// maps read once, 12 bytes written per token; for the 32 MB corpus at level
// 11 ~32 MB + 64 MB in and ~30 MB out, ~38 us at 3.35 TB/s. But the parse
// is serial per block: each token's cursor depends on the token before. A
// first version (one warp a block, every step a load from global memory,
// a token's ncand x (lazy + 1) match searches one after another) took
// 58 ms at -35 on an NVIDIA H100 80GB HBM3 at 700 W, 500x its floor.
//
// Design: only the cursor chain stays serial. One CTA of 16 warps per
// block holds the block's bytes and a bitmap of its candidate positions
// (n bits) in shared memory, one CTA an SM (224 KB for 128 KB blocks).
// The block goes by in chunks of 2048 positions (16 segments), a stage
// each, with a barrier between stages: in stage k twelve warps (those not
// numbered 4j) decide chunk k while warp 0, the walker, walks chunk k - 1
// (warps 4, 8 and 12 stay out, so no picker shares the walker's
// scheduler).
// - pick(s) depends on s alone (the lazy guard keeps s0 + step in s0's
//   segment), and its winner needs the match search only up to
//   min(seg_end, lim) + 3, at most 131 bytes: a candidate that survives
//   its segment shows v = seg_end - s + 3 whatever its full length, and
//   the earliest surviving map wins. So each picking thread takes a run
//   of consecutive positions and computes every pick (v, ml, d) there,
//   8 bytes a compare, reusing a map's last search while its distance
//   stays the same in the segment, and the back-extension start for the
//   floor max(d, segment start), 4 bytes a compare, from the previous
//   position's where it can: O(n * ncand * 131) byte compares at most,
//   whatever the data. A winner that survives its segment below lim
//   keeps its ml open;
// - then, for every position p of the chunk, the decision at s0, the
//   first candidate at or after p: the lazy step over the picks at
//   s0..s0+lazy, the token (s, ml, d, s - bk) and the cursor after it,
//   as one 16-byte record in a double buffer;
// - the walker's step is one shared-memory load: the record at the
//   cursor gives the token and the next cursor, and the next record's
//   load goes out before this token is stored. It extends an open ml
//   itself (128 bytes a step; the cursor then moves past those bytes),
//   and takes max(bk, cursor) as the token's start;
// - the pickers skip positions below the walker's cursor at the start of
//   their stage, since the cursor never goes back: a block that is one
//   long match costs two chunks of picks.
// The kernel's own clock, per block (parse_tokens_profile, a separate
// instance of the kernel, so the timed one reads no clock): the walker's
// and the pickers' busy cycles, the walker's steps, and the walker's busy
// time in ns on the card's global timer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kLastLiterals = 16;
constexpr int kMinLength = 21;
constexpr int kLongOff = 16;          // MM_LONGOFF
constexpr int kWarps = 16;            // warp 0 walks, warps 4, 8, 12 idle
constexpr int kPickers = (kWarps - kWarps / 4) * 32;  // warps 4k + 1..3
constexpr int kChunk = 2048;          // positions a stage (16 segments)
constexpr int kRowPad = 16;           // zero bytes past n in shared memory
constexpr int kMaxCand = 6;           // 1 + 4 k5 slots + far
constexpr int kOpen = -0x40000000;    // ml not known yet: extend
constexpr unsigned kAll = 0xffffffffu;
// what the walker reads at a cursor position p: the decision at s0, the
// first candidate at or after p, in one int4 {s - lo | back << 11 |
// kind << 18, d, ml, next} (s = s0 + the lazy step; next the cursor after
// it: s + ml, s0 + 1 or hi, kOpen while ml is)
constexpr int kNone = 0;              // no candidate in [p, hi)
constexpr int kSkip = 1;              // none left at s0: cursor = s0 + 1
constexpr int kToken = 2;

struct Pick {
  int v, ml, d, bk;   // bk: the back-extension start, floor max(d, seg0)
};

struct Block {
  const uint8_t* row;       // shared memory: n + kRowPad bytes
  const uint32_t* words;    // the same bytes as words
  const uint32_t* bits;     // candidate bitmap, n bits
  const uint16_t* maps;     // global: ncand x n
  int n, ncand, far, far_dist, lim;
};

// What a picking thread keeps from one position to the next: per map, the
// distance and first mismatching byte of its last match search (valid in
// one segment), and the last back-extension.
struct SearchCache {
  int seg_end;
  int d[kMaxCand], y[kMaxCand];
  int bk_d, bk_floor, bk_pos, bk;
};

__device__ __forceinline__ void reset(SearchCache& c) {
  c.seg_end = -1;
  c.bk_pos = -2;
}

__device__ __forceinline__ uint32_t word_at(const Block& B, int p) {
  const int k = p >> 2, sh = (p & 3) * 8;
  return __funnelshift_r(B.words[k], B.words[k + 1], sh);
}

__device__ __forceinline__ bool has_cand(const Block& B, int p) {
  return p < B.n && ((B.bits[p >> 5] >> (p & 31)) & 1u);
}

__device__ __forceinline__ uint64_t dword_at(const Block& B, int p) {
  const int k = p >> 2, sh = (p & 3) * 8;
  const uint32_t a = B.words[k], b = B.words[k + 1], c = B.words[k + 2];
  return static_cast<uint64_t>(__funnelshift_r(b, c, sh)) << 32 |
         __funnelshift_r(a, b, sh);
}

// The first byte y in [from, end) with row[y] != row[y - d], or end; 8
// bytes a step.
__device__ int first_diff(const Block& B, int from, int end, int d) {
  for (int y = from; y < end; y += 8) {
    uint64_t x = dword_at(B, y) ^ dword_at(B, y - d);
    const int left = end - y;
    if (left < 8) x &= (1ull << (8 * left)) - 1;
    if (x) return y + (__ffsll(static_cast<long long>(x)) - 1) / 8;
  }
  return end;
}

// The start of the match at s (distance d) extended backwards while the
// bytes before it agree, down to max(d, segment start of s); from the
// previous position's answer where that was s - 1 with the same d.
__device__ int back_start(const Block& B, int s, int d, SearchCache& c) {
  const int seg0 = s & ~(kSeg - 1);
  const int floor = d > seg0 ? d : seg0;
  int bk;
  if (c.bk_pos == s - 1 && c.bk_d == d && c.bk_floor == floor) {
    bk = s > floor && B.row[s - 1] == B.row[s - 1 - d] ? c.bk : s;
  } else {                    // 4 bytes a step, down to floor
    bk = s;
    while (bk > floor) {
      const int c = bk - floor < 4 ? bk - floor : 4, p = bk - c;
      uint32_t x = word_at(B, p) ^ word_at(B, p - d);
      if (c < 4) x &= (1u << (8 * c)) - 1;
      if (x) {                  // the highest differing byte stops it
        bk = p + (31 - __clz(x)) / 8 + 1;
        break;
      }
      bk = p;
    }
  }
  c.bk_d = d;
  c.bk_floor = floor;
  c.bk_pos = s;
  c.bk = bk;
  return bk;
}

// pick(s) of the contract, one thread, searching each map's match only up
// to min(seg_end, lim) + 3 and reusing the last search of the same map and
// distance in the segment; a winner that survives its segment below lim
// has ml = kOpen.
__device__ Pick eval_pick(const Block& B, int s, SearchCache& c) {
  const int seg_end = (s & ~(kSeg - 1)) + kSeg;
  const int bound = min(seg_end, B.lim);
  if (c.seg_end != seg_end) {
    c.seg_end = seg_end;
#pragma unroll
    for (int m = 0; m < kMaxCand; ++m) c.d[m] = 0;
  }
  Pick r = {-1, 0, 0, 0};
#pragma unroll
  for (int m = 0; m < kMaxCand; ++m) {
    if (m >= B.ncand) continue;
    const int raw = __ldg(B.maps + (size_t)m * B.n + s);
    if (raw == 0) continue;
    const bool is_far = B.far && m == B.ncand - 1;
    const int d = raw + (is_far ? B.far_dist - 1 : 0);
    if (d > s) continue;                // no source before the block
    int v, ml;
    if (s >= bound) {                   // no word to compare: x = lim
      ml = B.lim - s;
      v = B.lim >= seg_end ? seg_end - s + 3 : ml;
    } else {
      // bytes [s_prev, y) agree for the same d, so [s, y) too
      int y = c.y[m];
      if (c.d[m] != d || y < s) {
        y = first_diff(B, s, bound + 3, d);
        c.d[m] = d;
        c.y[m] = y;
      }
      const int x = y - 3 > s ? y - 3 : s;
      if (x < bound) {
        ml = min(x - s + 3, B.lim - s);
        v = ml;
      } else if (bound == B.lim) {      // no mismatch before lim
        ml = B.lim - s;
        v = B.lim >= seg_end ? seg_end - s + 3 : ml;
      } else {                          // survives its segment
        ml = kOpen;
        v = seg_end - s + 3;
      }
    }
    if (is_far && v < kLongOff) continue;
    if (v > r.v) r = {v, ml, d, 0};
  }
  if (r.v >= 0) r.bk = back_start(B, s, r.d, c);
  return r;
}

// The lazy step of the contract over the picks at s0 + step (v = -1 where
// the guard or the bitmap leaves none): the step whose pick takes over.
__device__ __forceinline__ int lazy_step(const int* v, int lazy) {
  int win = 0, v1 = v[0];
  for (int step = 1; step <= lazy; ++step) {
    if (v[step] > v1 + (step - win)) {
      win = step;
      v1 = v[step];
    }
  }
  return win;
}

// x of a match at s (distance d) known equal below seg_end + 3: from the
// first mismatching byte y in [seg_end + 3, lim + 3), lim if none. The
// warp, 128 bytes a step.
__device__ int extend(const Block& B, int seg_end, int d, int lane) {
  const int end = B.lim + 3;
  for (int y0 = seg_end + 3; y0 < end; y0 += 128) {
    const int y = y0 + 4 * lane;
    int at = 0x7fffffff;
    if (y < end) {
      uint32_t x = word_at(B, y) ^ word_at(B, y - d);
      const int left = end - y;
      if (left < 4) x &= (1u << (8 * left)) - 1;
      if (x) at = y + (__ffs(x) - 1) / 8;
    }
    const unsigned mask = __ballot_sync(kAll, at != 0x7fffffff);
    if (mask) return __shfl_sync(kAll, at, __ffs(mask) - 1) - 3;
  }
  return B.lim;
}

__device__ __forceinline__ void pickers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kPickers));
}

// The walker's state, kept in shared memory between stages, and what the
// profile records: the clock cycles the walker and the first picking warp
// were busy, the walker's steps (candidate positions visited) and its busy
// ns on the global timer. What the
// pickers read of it (the cursor, and whether the walk has ended) the
// walker of stage k writes to slot (k + 1) & 1, and everyone reads slot
// k & 1: no read races with a write of the same stage.
struct Walk {
  int cur, count, steps;
  int from[2], done[2];
  long long busy, pick_busy, busy_ns;
};

// kProfile: per block, int64 kProf fields into prof: block cycles, walker
// busy cycles, picker busy cycles, walker steps, walker busy ns.
constexpr int kProf = 5;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kProfile>
__global__ void __launch_bounds__(kWarps * 32, 1)
parse_tokens_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lens,
                    const uint16_t* __restrict__ maps, int n, int stride,
                    int ncand, int lazy, int far, int far_dist, int T,
                    int32_t* __restrict__ tok, int32_t* __restrict__ counts,
                    long long* __restrict__ prof) {
  const long long t_start = kProfile ? clock64() : 0;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Walk walk;
  __shared__ short next_word[kChunk / 32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lens[b];
  if (len < kMinLength) {
    if (threadIdx.x == 0) {
      counts[b] = 0;
      if (kProfile)
        for (int f = 0; f < kProf; ++f) prof[(size_t)b * kProf + f] = 0;
    }
    return;
  }
  const int rowb = (n + kRowPad + 15) & ~15;
  uint8_t* row = smem;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + rowb);
  // the pickers' picks of the chunk: ml, and d | back << 17 | (v + 1) << 24
  // (0 where no map is left: v = -1)
  int* pml = reinterpret_cast<int*>(smem + rowb + n / 8);
  uint32_t* pw = reinterpret_cast<uint32_t*>(pml + kChunk);
  // double-buffered for the walker: the record of every position
  int4* rec = reinterpret_cast<int4*>(pw + kChunk);   // [2][kChunk]

  // the row (8-byte aligned in global memory), zero past n + 8
  const uint8_t* grow = data + (size_t)b * stride;
  const uint2* g2 = reinterpret_cast<const uint2*>(grow);
  for (int i = threadIdx.x; i < stride / 8; i += blockDim.x)
    reinterpret_cast<uint2*>(row)[i] = __ldg(g2 + i);
  for (int i = stride + threadIdx.x; i < rowb; i += blockDim.x) row[i] = 0;
  // the bitmap: 8 positions a thread, each map read once as 16 bytes
  const uint16_t* bmaps = maps + (size_t)b * ncand * n;
  for (int i0 = 0; i0 < n / 8; i0 += blockDim.x) {  // whole warps
    const int i = i0 + threadIdx.x;
    uint32_t any = 0;
    for (int m = 0; m < ncand && i < n / 8; ++m) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          bmaps + (size_t)m * n) + i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        any |= (w[k] & 0xFFFFu ? 1u : 0u) << (2 * k);
        any |= (w[k] >> 16 ? 1u : 0u) << (2 * k + 1);
      }
    }
    // lanes 4j..4j+3 hold the 32 positions of bitmap word i / 4
    uint32_t word = any << (8 * (i & 3));
    word |= __shfl_down_sync(kAll, word, 1);
    word |= __shfl_down_sync(kAll, word, 2);
    if ((i & 3) == 0 && i < n / 8) bits[i >> 2] = word;
  }
  if (threadIdx.x == 0) walk = {0, 0, 0, {0, 0}, {0, 0}, 0, 0, 0};
  __syncthreads();

  Block B;
  B.row = row;
  B.words = reinterpret_cast<const uint32_t*>(row);
  B.bits = bits;
  B.maps = bmaps;
  B.n = n;
  B.ncand = ncand;
  B.far = far;
  B.far_dist = far_dist;
  B.lim = len - kLastLiterals;
  int32_t* out = tok + (size_t)b * (T + 1) * 3;
  const int chunks = (n + kChunk - 1) / kChunk;

  // stage k: warps 1-7 make the decisions of chunk k, warp 0 walks chunk
  // k - 1
  for (int k = 0; k <= chunks; ++k) {
    const bool ended = walk.done[k & 1];
    if (warp % 4 && k < chunks && !ended) {
      const long long t0 = kProfile ? clock64() : 0;
      const int lo = k * kChunk, hi = min(lo + kChunk, n);
      // the walker never comes back below its cursor
      const int from = walk.from[k & 1];
      const int t = (warp - 1 - warp / 4) * 32 + lane;   // picker index
      // 1. the picks at or past `from`, a run of positions a thread
      const int run = (hi - lo + kPickers - 1) / kPickers;
      SearchCache c;
      reset(c);
      for (int p = lo + t * run; p < min(lo + (t + 1) * run, hi); ++p) {
        if (p < from || !has_cand(B, p)) continue;
        const Pick r = eval_pick(B, p, c);
        pml[p - lo] = r.ml;
        pw[p - lo] = r.v < 0 ? 0u
                             : static_cast<uint32_t>(r.d | (p - r.bk) << 17) |
                                   static_cast<uint32_t>(r.v + 1) << 24;
      }
      // the next non-empty bitmap word of each word of the chunk
      const int nw = (hi - lo) / 32;
      if (warp == 1) {
        int carry = nw;
        for (int base = (nw - 1) & ~31; base >= 0; base -= 32) {
          const int j = base + lane;
          const unsigned mask =
              __ballot_sync(kAll, j < nw && bits[lo / 32 + j] != 0);
          const unsigned above = mask >> lane;   // words j.. of this 32
          if (j < nw)
            next_word[j] = above ? j + __ffs(above) - 1 : carry;
          if (mask) carry = base + __ffs(mask) - 1;
        }
      }
      pickers_sync();
      // 2. per position p: the decision at the first candidate s0 >= p in
      // the chunk (the lazy step over the picks, in s0's segment)
      int4* r = rec + (k & 1) * kChunk;
      for (int p = lo + t; p < hi; p += kPickers) {
        const uint32_t here = bits[p >> 5] & (kAll << (p & 31));
        int s0;
        if (here) {
          s0 = (p & ~31) + __ffs(here) - 1;
        } else {
          const int j = ((p - lo) >> 5) + 1 < nw ? next_word[((p - lo) >> 5) + 1]
                                                 : nw;
          s0 = j < nw ? lo + j * 32 + __ffs(bits[lo / 32 + j]) - 1 : hi;
        }
        if (p < from) continue;               // the walker is past p
        if (s0 >= hi) {
          r[p - lo] = make_int4(kNone << 18, 0, 0, hi);
          continue;
        }
        int v[3] = {static_cast<int>(pw[s0 - lo] >> 24) - 1, -1, -1};
        if (v[0] < 0) {
          r[p - lo] = make_int4(s0 - lo | kSkip << 18, 0, 0, s0 + 1);
          continue;
        }
        for (int step = 1; step <= lazy; ++step)
          if ((s0 & (kSeg - 1)) < kSeg - step && has_cand(B, s0 + step))
            v[step] = static_cast<int>(pw[s0 + step - lo] >> 24) - 1;
        const int q = s0 + lazy_step(v, lazy) - lo;
        const uint32_t w = pw[q];
        const int ml = pml[q];
        r[p - lo] = make_int4(q | ((w >> 17) & 0x7F) << 11 | kToken << 18,
                              w & 0x1FFFF, ml,
                              ml == kOpen ? kOpen : lo + q + ml);
      }
      __syncwarp();
      if (kProfile && threadIdx.x == 32) walk.pick_busy += clock64() - t0;
    } else if (warp == 0 && k > 0 && !ended) {
      const long long t0 = kProfile ? clock64() : 0;
      const long long n0 = kProfile ? global_ns() : 0;
      const int lo = (k - 1) * kChunk, hi = min(lo + kChunk, n);
      const int4* r = rec + ((k - 1) & 1) * kChunk;
      // cur >= lo: a token moves the cursor on by ml >= 0
      int cur = walk.cur, count = walk.count, done = 0, steps = 0;
      // One hop a record: the next record's load is issued before this
      // one's token is stored. Every hop stores to slot `count` (all lanes
      // the same words); a hop without a token leaves it to the next
      // token, or to the spare slot T.
      int4 e = cur < hi ? r[cur - lo] : make_int4(0, 0, 0, 0);
      while (cur < hi) {
        const int kind = e.x >> 18;
        const int s = lo + (e.x & 0x7FF), d = e.y;
        int ml = e.z, next = e.w;
        if (ml == kOpen) {                      // a token's only
          const int x = extend(B, (s & ~(kSeg - 1)) + kSeg, d, lane);
          ml = x >= B.lim ? B.lim - s : min(x - s + 3, B.lim - s);
          next = s + ml;
        }
        const int4 en = next < hi ? r[next - lo] : e;
        if (kind == kToken && count >= T) {
          count = -1;
          done = 1;
          break;
        }
        const int bk = max(s - ((e.x >> 11) & 0x7F), cur);
        int32_t* o = out + 3 * count;
        o[0] = bk;
        o[1] = ml + s - bk;
        o[2] = d;
        count += kind == kToken;
        if (kProfile) steps += kind != kNone;
        cur = next;
        e = en;
      }
      if (lane == 0) {
        walk.cur = cur;
        walk.count = count;
        if (kProfile) {
          walk.steps += steps;
          walk.busy += clock64() - t0;
          walk.busy_ns += global_ns() - n0;
        }
        walk.from[(k + 1) & 1] = cur;
        walk.done[(k + 1) & 1] = done;
      }
    } else if (warp == 0 && lane == 0 && ended) {
      walk.done[(k + 1) & 1] = 1;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    counts[b] = walk.count;
    if (kProfile) {
      long long* pr = prof + (size_t)b * kProf;
      pr[0] = clock64() - t_start;
      pr[1] = walk.busy;
      pr[2] = walk.pick_busy;
      pr[3] = walk.steps;
      pr[4] = walk.busy_ns;
    }
  }
}

}  // namespace

// Dynamic shared memory of one CTA for blocks of n bytes: the row, the
// bitmap, the picks, and the double buffer of records.
static size_t parse_smem(int n) {
  return ((n + kRowPad + 15) & ~15) + n / 8 + 2 * kChunk * sizeof(int) +
         2 * kChunk * sizeof(int4);
}

// data: (B, stride) uint8 rows; lens: (B,) int32; maps: (B, ncand, n)
// uint16, ncand <= 6; tok: (B, T + 1, 3) int32 (slot T spare); counts: (B,)
// int32; prof: null, or (B, 5) int64 for the profiling instance. n is a
// multiple of 128 and stride = n + 8. Returns the launch's cudaError_t.
extern "C" int parse_tokens_launch(const void* data, const void* lens,
                                   const void* maps, int B, int n, int stride,
                                   int ncand, int lazy, int far, int far_dist,
                                   int T, void* tok, void* counts,
                                   void* prof, void* stream) {
  const size_t smem = parse_smem(n);
  const auto kernel =
      prof ? parse_tokens_kernel<true> : parse_tokens_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint16_t*)maps, n,
      stride, ncand, lazy, far, far_dist, T, (int32_t*)tok,
      (int32_t*)counts, (long long*)prof);
  return (int)cudaGetLastError();
}
