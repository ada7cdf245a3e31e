// huf_decode: Huff0 (X1, four streams) entropy decode of a batch of blobs,
// written straight into the LZ decoder's staged stream tensors, on an H100
// (sm_90a).
//
// Replaces four Pallas TPU kernels of lizard_tpu/ops. Their contract, not
// their tiling:
// - huf128.py::_huf128_kernel (l.83, launched by _huf128_call l.373): the
//   Huff0 bit decode of many segments, tableLog <= 11, which emits
//   canonical symbol ranks;
// - huf128.py::_translate_kernel (l.407, _translate_call l.425): rank ->
//   symbol through each blob's 256-entry LUT. Here the decode table holds
//   the symbol itself, so the lookup that decodes a symbol also translates
//   it;
// - fuse.py::_compact_kernel (l.58, _compact_call l.137): rebuilds each
//   Huffman stream contiguously in the LZ pool from its four scattered
//   segments. Here each segment stores its symbols at dst_off + k of its
//   destination tensor, which is that function;
// - lane_huf.py::_huf_lane_kernel (l.88, _huf_lane_call l.312): the older
//   Huff0 X1 decode of a batch of blobs (tableLog <= 11, its bitstreams
//   scheduled onto slots), the same function; its host side is
//   lizard_tpu_torch/ops/lane_huf.py::huf_decompress_lanes.
//
// What bounds it on this card: a segment decoded symbol after symbol is one
// chain of dependent table lookups (a symbol's bit position depends on the
// previous symbol's code length), about 24 K lookups for the longest
// segment at level 41, and that chain, not the bytes, set the time of a
// design with one thread a segment. The HBM floor, the blob bytes read once
// and the decoded bytes written once over 3.35 TB/s, is about 8 us at -41
// (10.6 MB in, 16.1 MB out).
//
// Design: one CTA of four warps per blob, one warp per segment, the blob's
// decode table (1 << tableLog uint16 entries sym | nbits << 8, at most 8 KB)
// in shared memory once. The warp cuts its segment's bit range into 32
// equal ranges, one a lane, and decodes them at the same time by
// self-synchronisation:
// 1. each lane decodes from the top of its range (lane 0 from the true
//    start) until its position passes the range's bottom, and keeps its
//    start, its symbol count and its exit position;
// 2. a lane whose start is not the exit of the lane above it (the true
//    path's first position in its range) decodes again from that exit, in
//    lockstep with its old path, until the two paths meet (a prefix code
//    falls into step within a few symbols) or leave the range; the
//    symbol count moves by the difference, and a changed exit is passed
//    down in the next round. Lane i is right after round i, so a code that
//    never synchronises (equal 8-bit codes from a misaligned start) takes
//    at most 31 rounds, one lane each: a serial decode inside the kernel,
//    exact, never a host fallback (the rounds a segment took are written
//    to `rounds` where that pointer is not null);
// 3. a warp prefix sum of the counts gives each lane its output offset;
//    the segment is kOk only if the true path has exactly n_out symbols
//    above bit 0 and ends on bit 0; each lane of a kOk segment decodes its
//    range once more and stores its symbols, four to a 32-bit store where
//    aligned.
// Each step reads the bits through a 64-bit window of aligned 32-bit words
// (read through the read-only cache, the next word fetched one refill
// ahead) and uses 32-bit positions relative to the lane's range.
//
// Bit semantics are those of lizard_tpu/ref/huf.py::BitReader, the backward
// stream of bitstream.h:255-338: the stream is a little-endian number read
// from its last byte down, starting below the end-mark bit; each symbol
// looks at the top tableLog bits and skips nbits; an over-read supplies zero
// bits; the segment is valid only if exactly 0 bits remain after its n_out
// symbols. The kernel reads only aligned 32-bit words that hold a byte of
// `data`, and writes only [dst_off, dst_off + n_out) of its tensor, and only
// for a kOk segment (a corrupt segment's bytes are undefined): it checks
// every row against the sizes of the tensors first (the wrapper does not
// read the table, which would wait for the device), and a row outside them
// gets kErrBounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableEntries = 1 << 12;   // HUF_TABLELOG_MAX
constexpr int kSegments = 4;             // per blob, one warp each
constexpr int kFields = 6;               // segment table row
constexpr int kLanes = 32;
constexpr unsigned kAll = 0xffffffffu;

// status codes, shared with lizard_tpu_torch/ops/huf128.py
constexpr int kOk = 0;
constexpr int kErrNotConsumed = -1;
constexpr int kErrEndMark = -2;
constexpr int kErrBounds = -3;

// segs: (n_blobs * 4, 6) int64 rows src_off, src_len, dst_kind, dst_off,
// n_out, table_id; the four rows of a blob name one table. Dests holds the
// pointer and size of flags, literals, off16 and off24 (dst_kind 0-3).
struct Dests {
  uint8_t* ptr[4];
  int64_t size[4];
};

// Reads the bits of one lane's range. Positions t are relative to the
// range's bottom (t = p - lo); bit t of the lane is bit r0 + t of the words
// at wp. Words below kmin lie before `data` and read as zero.
struct Reader {
  const uint32_t* wp;
  int r0, kmin, tz, tl;
  uint32_t mask;
  int cj;          // the window holds words cj - 1 (low) and cj (high)
  uint64_t win;
  uint32_t nxt;    // word cj - 2, fetched ahead

  __device__ __forceinline__ uint32_t word(int k) const {
    return k >= kmin ? __ldg(wp + k) : 0u;
  }

  // Start reading downwards from t (the window of the first symbol).
  __device__ __forceinline__ void seek(int t) {
    cj = (r0 + t - 1) >> 5;
    win = (static_cast<uint64_t>(word(cj)) << 32) | word(cj - 1);
    nxt = word(cj - 2);
  }

  // The table index of the symbol that starts at t (t + lo >= 1): the
  // tableLog bits below t, bits below the segment's start read as zero.
  // Positions only go down, by at most 12 a step, so the window moves by at
  // most one word.
  __device__ __forceinline__ uint32_t index(int t) {
    const int a = r0 + t;
    if (((a - 1) >> 5) < cj) {
      --cj;
      win = (win << 32) | nxt;
      nxt = word(cj - 2);
    }
    uint32_t v = static_cast<uint32_t>(win >> (a - tl - 32 * (cj - 1))) & mask;
    if (t < tz) v &= ~((1u << (tz - t)) - 1);
    return v;
  }
};

__global__ void __launch_bounds__(kSegments * kLanes)
huf_decode_kernel(const uint8_t* __restrict__ data, int64_t n_data,
                  const int64_t* __restrict__ segs, int64_t n_blobs,
                  const uint16_t* __restrict__ tables,
                  const int32_t* __restrict__ table_log, int64_t n_tables,
                  Dests dests, int32_t* __restrict__ status,
                  int32_t* __restrict__ rounds_out) {
  __shared__ uint16_t table[kTableEntries];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int64_t blob = blockIdx.x;
  const int64_t* rows = segs + blob * kSegments * kFields;
  int32_t* st = status + blob * kSegments + warp;
  const int64_t tid = rows[5];
  const int tl = (tid >= 0 && tid < n_tables) ? table_log[tid] : 0;
  if (tl < 1 || tl > 12) {  // the whole CTA
    if (lane == 0) *st = kErrBounds;
    return;
  }
  const uint16_t* gtable = tables + tid * kTableEntries;
  for (int i = threadIdx.x; i < (1 << tl); i += blockDim.x)
    table[i] = gtable[i];
  __syncthreads();

  const int64_t* row = rows + warp * kFields;
  const int64_t src_off = row[0], len = row[1], kind = row[2];
  const int64_t dst_off = row[3], n_out = row[4];
  if (row[5] != tid || src_off < 0 || len < 1 || src_off + len > n_data ||
      kind < 0 || kind > 3 || n_out < 0 || dst_off < 0 ||
      dst_off + n_out > dests.size[kind]) {
    if (lane == 0) *st = kErrBounds;
    return;
  }
  const unsigned last = data[src_off + len - 1];
  if (last == 0) {
    if (lane == 0) *st = kErrEndMark;
    return;
  }
  // payload bits below the end mark: symbols start at positions (0, P]
  const int64_t P = (len - 1) * 8 + (31 - __clz(last));
  const int64_t R = (P + kLanes - 1) / kLanes;
  const int64_t hi = P - lane * R > 0 ? P - lane * R : 0;
  const int64_t lo = P - (lane + 1) * R > 0 ? P - (lane + 1) * R : 0;
  const int top = static_cast<int>(hi - lo);   // this lane's t range (0, top]

  // the words of data from its first aligned one: bit t of this lane's
  // range is bit r0 + t of the words at wp
  const uintptr_t base = reinterpret_cast<uintptr_t>(data) & ~uintptr_t(3);
  const int64_t sbyte = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(data) - base) + src_off;
  const int64_t bits0 = sbyte * 8 + lo;        // lane bit 0, from base
  Reader rd;
  rd.wp = reinterpret_cast<const uint32_t*>(base) + (bits0 >> 5);
  rd.r0 = static_cast<int>(bits0 & 31);
  rd.kmin = (bits0 >> 5) < 4 ? static_cast<int>(-(bits0 >> 5)) : -4;
  rd.tz = lo < tl ? static_cast<int>(tl - lo) : 0;
  rd.tl = tl;
  rd.mask = (1u << tl) - 1;
  Reader ro = rd;                              // the old path in a redo

  // 1. decode the range from its top
  int s = top;                                 // this lane's start
  int cnt = 0;
  int t = s;
  if (t > 0) rd.seek(t);
  while (t > 0) {
    t -= table[rd.index(t)] >> 8;
    ++cnt;
  }
  int ex = t;                                  // exit, <= 0

  // 2. rounds: take the upper lane's exit as the start, until none changes
  int rounds = 0;
  for (; rounds < kLanes; ++rounds) {
    // the upper lane's exit, in this lane's frame: its lo is our hi
    const int up = __shfl_up_sync(kAll, ex, 1) + top;
    const bool redo = lane > 0 && up != s;
    if (!__any_sync(kAll, redo)) break;
    if (redo) {
      int q = up, o = s, cn = 0, co = 0;
      if (q > 0) rd.seek(q);
      if (o > 0) ro.seek(o);
      while (true) {
        if (q == o) {                          // met: the rest is the same
          cnt += cn - co;
          break;
        }
        if (q <= 0 && o <= 0) {                // both left the range apart
          cnt = cn;
          ex = q;
          break;
        }
        if (q > o) {
          q -= table[rd.index(q)] >> 8;
          ++cn;
        } else {
          o -= table[ro.index(o)] >> 8;
          ++co;
        }
      }
      s = up;
    }
  }

  // 3. offsets, status, then the stores of a kOk segment
  int off = cnt;
  for (int d = 1; d < kLanes; d <<= 1) {
    const int x = __shfl_up_sync(kAll, off, d);
    if (lane >= d) off += x;
  }
  const int64_t total = __shfl_sync(kAll, off, kLanes - 1);
  off -= cnt;                                  // exclusive
  // the last lane's range ends at bit 0, so its exit is where the path ends
  const int path_end = __shfl_sync(kAll, ex, kLanes - 1);
  const bool ok = total == n_out && path_end == 0;
  if (lane == 0) {
    *st = ok ? kOk : kErrNotConsumed;
    if (rounds_out) rounds_out[blob * kSegments + warp] = rounds;
  }
  if (!ok || cnt == 0) return;

  uint8_t* o8 = dests.ptr[kind] + dst_off + off;
  const int head = min(cnt, static_cast<int>(
      (4 - (reinterpret_cast<uintptr_t>(o8) & 3)) & 3));
  const int body = head + ((cnt - head) & ~3);
  t = s;
  rd.seek(t);
  int k = 0;
  for (; k < head; ++k) {
    const uint32_t e = table[rd.index(t)];
    o8[k] = static_cast<uint8_t>(e);
    t -= e >> 8;
  }
  for (; k < body; k += 4) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t e = table[rd.index(t)];
      w |= (e & 0xFF) << (8 * b);
      t -= e >> 8;
    }
    *reinterpret_cast<uint32_t*>(o8 + k) = w;
  }
  for (; k < cnt; ++k) {
    const uint32_t e = table[rd.index(t)];
    o8[k] = static_cast<uint8_t>(e);
    t -= e >> 8;
  }
}

}  // namespace

extern "C" int huf_decode_launch(const uint8_t* data, int64_t n_data,
                                 const int64_t* segs, int64_t n_seg,
                                 const uint16_t* tables,
                                 const int32_t* table_log, int64_t n_tables,
                                 uint8_t* flags, uint8_t* literals,
                                 uint8_t* off16, uint8_t* off24,
                                 int64_t n_flags, int64_t n_literals,
                                 int64_t n_off16, int64_t n_off24,
                                 int32_t* status, int32_t* rounds,
                                 void* stream) {
  const int64_t n_blobs = n_seg / kSegments;
  if (n_blobs <= 0) return 0;
  const Dests dests{{flags, literals, off16, off24},
                    {n_flags, n_literals, n_off16, n_off24}};
  huf_decode_kernel<<<static_cast<unsigned>(n_blobs), kSegments * kLanes, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      data, n_data, segs, n_blobs, tables, table_log, n_tables, dests,
      status, rounds);
  return static_cast<int>(cudaGetLastError());
}
