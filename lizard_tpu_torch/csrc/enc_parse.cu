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
// Every token advances the cursor by >= 4 bytes, so n/4 + 1 slots suffice;
// there is no token cap, no iteration cap and no overflow fallback. A block
// that would exceed its slots (impossible for match_find's maps) gets count
// -1.
//
// What bounds it on this card: bytes, at the floor: the block and its ncand
// maps read once, 12 bytes written per token; for the 32 MB corpus at level
// 11 ~32 MB + 64 MB in and ~30 MB out, ~38 us at 3.35 TB/s. The parse is
// serial per block, a chain of dependent warp-wide steps per token (scan,
// extend, lazy picks, back-extension), so latency sets the time.
//
// Design, a first version: one warp per block. All lanes hold the parse
// state; the searches are lane-parallel with a ballot: the next candidate
// position (32 positions a step), the first mismatching byte y of a match
// (32 bytes a step; the first mismatching word is max(s, y - 3)), and the
// back-extension (32 bytes a step). Bytes and maps are read from global
// memory through the read-only cache.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kLastLiterals = 16;
constexpr int kMinLength = 21;
constexpr int kLongOff = 16;          // MM_LONGOFF
constexpr unsigned kAll = 0xffffffffu;

struct Pick {
  int v, ml, d;
};

struct Block {
  const uint8_t* row;
  const uint16_t* maps;
  int n, ncand, far, far_dist, lim;
};

__device__ __forceinline__ int byte_at(const uint8_t* row, int k) {
  return __ldg(row + k);
}

__device__ __forceinline__ bool any_cand(const Block& B, int q) {
  for (int m = 0; m < B.ncand; ++m)
    if (__ldg(B.maps + (size_t)m * B.n + q) != 0) return true;
  return false;
}

// The first position >= from with a candidate in any map, or n.
__device__ int next_cand(const Block& B, int from, int lane) {
  for (int q0 = from; q0 < B.n; q0 += 32) {
    const int q = q0 + lane;
    const unsigned mask = __ballot_sync(kAll, q < B.n && any_cand(B, q));
    if (mask) return q0 + __ffs(mask) - 1;
  }
  return B.n;
}

// The first x >= s with a 4-byte word mismatch between s and s - d, lim if
// none before lim: from the first mismatching byte y in [s, lim + 3).
__device__ int mismatch(const Block& B, int s, int d, int lane) {
  const int yend = B.lim + 3;
  for (int y0 = s; y0 < yend; y0 += 32) {
    const int y = y0 + lane;
    const bool mm =
        y < yend && byte_at(B.row, y) != byte_at(B.row, y - d);
    const unsigned mask = __ballot_sync(kAll, mm);
    if (mask) {
      const int x = y0 + __ffs(mask) - 1 - 3;
      return x > s ? x : s;
    }
  }
  return B.lim;
}

__device__ Pick pick(const Block& B, int s, int seg_end, int lane) {
  Pick r = {-1, 0, 0};
  for (int m = 0; m < B.ncand; ++m) {
    const int raw = __ldg(B.maps + (size_t)m * B.n + s);
    if (raw == 0) continue;
    const bool is_far = B.far && m == B.ncand - 1;
    const int d = raw + (is_far ? B.far_dist - 1 : 0);
    if (d > s) continue;                // no source before the block
    const int x = mismatch(B, s, d, lane);
    const int ml = x >= B.lim ? B.lim - s
                              : min(x - s + 3, B.lim - s);
    const int v = x >= seg_end ? seg_end - s + 3 : ml;
    if (is_far && v < kLongOff) continue;
    if (v > r.v) r = {v, ml, d};
  }
  return r;
}

// The start of the match at s (distance d) extended backwards down to
// floor at the lowest.
__device__ int back_extend(const Block& B, int s, int d, int floor,
                           int lane) {
  for (int k0 = 0;; k0 += 32) {
    const int y = s - 1 - k0 - lane;
    const bool stop =
        y < floor || byte_at(B.row, y) != byte_at(B.row, y - d);
    const unsigned mask = __ballot_sync(kAll, stop);
    if (mask) return s - (k0 + __ffs(mask) - 1);
  }
}

__global__ void __launch_bounds__(32)
parse_tokens_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lens,
                    const uint16_t* __restrict__ maps, int n, int stride,
                    int ncand, int lazy, int far, int far_dist, int T,
                    int32_t* __restrict__ tok, int32_t* __restrict__ counts) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int len = lens[b];
  int32_t* out = tok + (size_t)b * T * 3;
  int count = 0;
  if (len >= kMinLength) {
    Block B;
    B.row = data + (size_t)b * stride;
    B.maps = maps + (size_t)b * ncand * n;
    B.n = n;
    B.ncand = ncand;
    B.far = far;
    B.far_dist = far_dist;
    B.lim = len - kLastLiterals;
    int cur = 0;
    while (true) {
      const int s0 = next_cand(B, cur, lane);
      if (s0 >= n) break;
      const int seg_end = (s0 & ~(kSeg - 1)) + kSeg;
      Pick p1 = pick(B, s0, seg_end, lane);
      if (p1.v < 0) {
        cur = s0 + 1;
        continue;
      }
      int s = s0;
      for (int step = 1; step <= lazy; ++step) {
        if ((s0 & (kSeg - 1)) < kSeg - step && any_cand(B, s0 + step)) {
          const Pick p2 = pick(B, s0 + step, seg_end, lane);
          if (p2.v > p1.v + (s0 + step - s)) {
            s = s0 + step;
            p1 = p2;
          }
        }
      }
      int floor = cur > p1.d ? cur : p1.d;
      const int seg0 = s & ~(kSeg - 1);
      if (seg0 > floor) floor = seg0;
      const int bk = back_extend(B, s, p1.d, floor, lane);
      if (count >= T) {
        count = -1;
        break;
      }
      if (lane == 0) {
        out[3 * count] = bk;
        out[3 * count + 1] = p1.ml + s - bk;
        out[3 * count + 2] = p1.d;
      }
      ++count;
      cur = s + p1.ml;
    }
  }
  if (lane == 0) counts[b] = count;
}

}  // namespace

// data: (B, stride) uint8 rows; lens: (B,) int32; maps: (B, ncand, n)
// uint16; tok: (B, T, 3) int32; counts: (B,) int32. Returns the launch's
// cudaError_t.
extern "C" int parse_tokens_launch(const void* data, const void* lens,
                                   const void* maps, int B, int n, int stride,
                                   int ncand, int lazy, int far, int far_dist,
                                   int T, void* tok, void* counts,
                                   void* stream) {
  parse_tokens_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint16_t*)maps, n,
      stride, ncand, lazy, far, far_dist, T, (int32_t*)tok,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}
