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
//   segments. Here the thread of a segment stores its symbols at
//   dst_off + k of its destination tensor, which is that function;
// - lane_huf.py::_huf_lane_kernel (l.88, _huf_lane_call l.312): the older
//   Huff0 X1 decode of a batch of blobs (tableLog <= 11, its bitstreams
//   scheduled onto slots), the same function; its host side is
//   lizard_tpu_torch/ops/lane_huf.py::huf_decompress_lanes.
//
// What bounds it on this card: each segment is a serial chain of dependent
// table lookups (a symbol's bit position depends on the previous symbol's
// code length), about 24 K lookups for the longest segment at level 41. The
// HBM floor, the blob bytes read once and the decoded bytes written once
// over 3.35 TB/s, is about 8 us at -41 (10.6 MB in, 16.1 MB out); the chains'
// latency, not the bandwidth, sets the time.
//
// Design, a first version: one warp per blob. The warp copies the blob's
// decode table (1 << tableLog uint16 entries sym | nbits << 8, tableLog <=
// 12, so at most 8 KB) into shared memory; lanes 0-3 then decode one
// segment each, one symbol per step, from a 64-bit bit container refilled
// backwards. That leaves 28 of 32 lanes idle, and a batch gives one warp per
// blob (about 476 at -41) for 132 SMs: more segments in flight per SM
// (several bit containers per thread, interleaved) is later work.
//
// Bit semantics are those of lizard_tpu/ref/huf.py::BitReader, the backward
// stream of bitstream.h:255-338: the stream is a little-endian number read
// from its last byte down, starting below the end-mark bit; each symbol
// looks at the top tableLog bits and skips nbits; an over-read supplies zero
// bits; the segment is valid only if exactly 0 bits remain after its n_out
// symbols. The kernel reads no byte outside [src, src + len) and writes only
// [dst_off, dst_off + n_out) of its tensor: it checks every row against the
// sizes of the tensors first (the wrapper does not read the table, which
// would wait for the device), and a row outside them gets kErrBounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kTableEntries = 1 << 12;   // HUF_TABLELOG_MAX
constexpr int kSegments = 4;             // per blob
constexpr int kFields = 6;               // segment table row

// status codes, shared with lizard_tpu_torch/ops/huf128.py
constexpr int kOk = 0;
constexpr int kErrNotConsumed = -1;
constexpr int kErrEndMark = -2;
constexpr int kErrBounds = -3;

// The little-endian value of the n <= 8 bytes at p.
__device__ __forceinline__ uint64_t load_le(const uint8_t* p, int64_t n) {
  uint64_t c = 0;
  for (int64_t k = n - 1; k >= 0; --k) c = (c << 8) | p[k];
  return c;
}

// The byte index of a container that holds bits [8b, 8b + 64) and so the
// bits just below `pos` (pos >= 0): its top byte is the one holding bit
// pos - 1, and it starts at the segment's first byte at the lowest.
__device__ __forceinline__ int64_t container_base(int64_t pos) {
  const int64_t b = (pos + 7) / 8 - 8;
  return b > 0 ? b : 0;
}

// segs: (n_blobs * 4, 6) int64 rows src_off, src_len, dst_kind, dst_off,
// n_out, table_id; the four rows of a blob name one table. Dests holds the
// pointer and size of flags, literals, off16 and off24 (dst_kind 0-3).
struct Dests {
  uint8_t* ptr[4];
  int64_t size[4];
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
huf_decode_kernel(const uint8_t* __restrict__ data, int64_t n_data,
                  const int64_t* __restrict__ segs, int64_t n_blobs,
                  const uint16_t* __restrict__ tables,
                  const int32_t* __restrict__ table_log, int64_t n_tables,
                  Dests dests, int32_t* __restrict__ status) {
  __shared__ uint16_t smem[kWarpsPerBlock][kTableEntries];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t blob = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (blob >= n_blobs) return;  // whole warp
  const int64_t* rows = segs + blob * kSegments * kFields;
  int32_t* st = status + blob * kSegments + lane;
  const int64_t tid = rows[5];
  const int tl = (tid >= 0 && tid < n_tables) ? table_log[tid] : 0;
  if (tl < 1 || tl > 12) {  // whole warp
    if (lane < kSegments) *st = kErrBounds;
    return;
  }
  uint16_t* table = smem[warp];
  const uint16_t* gtable = tables + tid * kTableEntries;
  for (int i = lane; i < (1 << tl); i += 32) table[i] = gtable[i];
  __syncwarp();
  if (lane >= kSegments) return;

  const int64_t* row = rows + lane * kFields;
  const int64_t src_off = row[0], len = row[1], kind = row[2];
  const int64_t dst_off = row[3], n_out = row[4];
  if (row[5] != tid || src_off < 0 || len < 1 || src_off + len > n_data ||
      kind < 0 || kind > 3 || n_out < 0 || dst_off < 0 ||
      dst_off + n_out > dests.size[kind]) {
    *st = kErrBounds;
    return;
  }
  const uint8_t* src = data + src_off;
  uint8_t* dst = dests.ptr[kind] + dst_off;
  const unsigned last = src[len - 1];
  if (last == 0) {
    *st = kErrEndMark;
    return;
  }
  // payload bits below the end mark
  int64_t pos = (len - 1) * 8 + (31 - __clz(last));
  int64_t b = container_base(pos);
  uint64_t c = load_le(src + b, len - b < 8 ? len - b : 8);
  const uint32_t mask = (1u << tl) - 1;
  for (int64_t i = 0; i < n_out; ++i) {
    int64_t avail = pos - 8 * b;  // container bits below pos
    if (avail < tl && b > 0) {    // refill: then 57 <= avail <= 64
      b = container_base(pos);
      c = load_le(src + b, len - b < 8 ? len - b : 8);
      avail = pos - 8 * b;
    }
    uint32_t v;
    if (avail >= tl) {
      v = static_cast<uint32_t>(c >> (avail - tl)) & mask;
    } else if (pos > 0) {         // b == 0: the bits below byte 0 are zeros
      v = static_cast<uint32_t>(c << (tl - pos)) & mask;
    } else {                      // over-read past the start
      v = 0;
    }
    const uint32_t e = table[v];
    dst[i] = static_cast<uint8_t>(e);
    pos -= e >> 8;
  }
  *st = pos == 0 ? kOk : kErrNotConsumed;
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
                                 int32_t* status, void* stream) {
  const int64_t n_blobs = n_seg / kSegments;
  if (n_blobs <= 0) return 0;
  const Dests dests{{flags, literals, off16, off24},
                    {n_flags, n_literals, n_off16, n_off24}};
  const dim3 grid(static_cast<unsigned>(
      (n_blobs + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  huf_decode_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      data, n_data, segs, n_blobs, tables, table_log, n_tables, dests,
      status);
  return static_cast<int>(cudaGetLastError());
}
