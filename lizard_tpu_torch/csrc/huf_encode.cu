// huf_pack: Huff0 (four streams, 1X) bitstream packing of a batch of
// streams, on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel lizard_tpu/ops/enc_huf.py::_henc_kernel
// (l.41, launched by henc_call l.196). Its contract, not its tiling: per
// segment, each symbol's (code, nbits) from its stream's table, the bit
// offsets by a prefix sum, the codes ORed into 32-bit little-endian words,
// the words stored densely. The TPU kernel packed 8 streams on the sublanes
// of (8, 128) tiles, with roll-based scans, a segmented OR-scan and a
// binary-search compaction, and the host reordered the symbols; here a warp
// scans 32 codes with shuffles and ORs them into a shared-memory window,
// and the symbols are read backwards in place.
//
// Bit semantics are those of lizard_tpu/ref/huf_encode.py::_huf_encode_1x
// and BitWriter (bitstream.h:181-248): the symbols go from the segment's
// last byte down to its first (the reference's order: the tail bytes n2+2,
// n2+1, n2, then n2-1 .. 0, which is n-1 .. 0), each code LSB first after
// the previous one, then one end-mark bit.
//
// What bounds it on this card: each segment is a serial chain of steps (the
// bit position of a step depends on every code before it), about 1 K steps
// of 32 symbols for the 32 KB segments of a 128 KB stream. The HBM floor, the
// symbols and tables read once and the words written once over 3.35 TB/s, is
// a few microseconds for a 32 MB batch; the steps' latency, not the
// bandwidth, sets the time.
//
// Design, a first version: one thread block per stream, one warp per
// segment (4 warps). The block copies the stream's 256-entry table (nbits <<
// 16 | code) into shared memory once. Per step each lane looks up one symbol,
// a warp inclusive scan (__shfl_up_sync) gives its bit offset from the
// segment's running position, and the lane ORs its code (and the part that
// spills into the next word) into the warp's window of words in shared
// memory. The words the step completed go out to global memory, coalesced,
// and the partial last word becomes the window's first. The end mark and the
// bit count are written last. Several segments per warp, wider loads and
// overlap with the host's emitters are later work.
//
// The kernel reads no byte outside [src_off, src_off + len) and writes only
// the segment's words [out_word_off, out_word_off + segment_words(len)): it
// checks every row against the sizes of the tensors first (the wrapper does
// not read the rows, which would wait for the device), and a row outside them
// gets kErrBounds. A symbol whose entry has nbits 0 or above 32 gives
// kErrNoCode; bits that with the end mark exceed the segment's words give
// kErrOverflow (only codes longer than 11 bits can). Either clears the
// segment's words and sets its bit count to 0, as the plain version does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSegments = 4;            // per stream, one warp each
constexpr int kFields = 4;              // segment row
constexpr int kTableEntries = 256;
constexpr int kMaxBits = 11;            // the words reserved per symbol
// A step of 32 codes of at most 32 bits that starts at bit 31 of the
// window's first word ends in word (31 + 32 * 32 - 1) / 32 = 32.
constexpr int kWindow = 33;

// status codes, shared with lizard_tpu_torch/ops/enc_huf.py
constexpr int kOk = 0;
constexpr int kErrNoCode = -1;
constexpr int kErrOverflow = -2;
constexpr int kErrBounds = -3;

__host__ __device__ __forceinline__ int64_t segment_words(int64_t len) {
  return (len * kMaxBits + 31) / 32 + 1;
}

// segs: (n_streams * 4, 4) int64 rows src_off, len, table_row,
// out_word_off; the four rows of a stream name one table.
__global__ void __launch_bounds__(kSegments * 32)
huf_pack_kernel(const uint8_t* __restrict__ data, int64_t n_data,
                const int64_t* __restrict__ segs,
                const uint32_t* __restrict__ tables, int64_t n_tables,
                uint32_t* __restrict__ words, int64_t n_words,
                int64_t* __restrict__ bits, int32_t* __restrict__ status) {
  __shared__ uint32_t table[kTableEntries];
  __shared__ uint32_t window[kSegments][kWindow];
  const int warp = threadIdx.x / 32;
  const uint32_t lane = threadIdx.x % 32;
  const unsigned full = 0xFFFFFFFFu;
  const int64_t* rows = segs + static_cast<int64_t>(blockIdx.x) * kSegments * kFields;
  const int64_t tid = rows[2];
  const bool table_ok = tid >= 0 && tid < n_tables;
  if (table_ok) {
    for (int i = threadIdx.x; i < kTableEntries; i += blockDim.x)
      table[i] = tables[tid * kTableEntries + i];
  }
  uint32_t* win = window[warp];
  for (uint32_t i = lane; i < kWindow; i += 32) win[i] = 0;
  __syncthreads();

  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kSegments + warp;
  const int64_t* row = rows + warp * kFields;
  const int64_t src_off = row[0], len = row[1], out_off = row[3];
  if (!table_ok || row[2] != tid || src_off < 0 || len < 0 ||
      src_off + len > n_data || out_off < 0 ||
      out_off + segment_words(len) > n_words) {  // whole warp
    if (lane == 0) {
      status[seg] = kErrBounds;
      bits[seg] = 0;
    }
    return;
  }
  const uint8_t* src = data + src_off;
  uint32_t* out = words + out_off;
  const int64_t cap = segment_words(len);
  const int64_t limit = 32 * cap;  // bits the words hold, end mark included
  int64_t pos = 0;                 // bits so far; win[0] is word pos >> 5
  bool no_code = false, overflow = false;
  for (int64_t k0 = 0; k0 < len; k0 += 32) {
    const int64_t k = k0 + lane;   // emission index
    uint32_t nb = 0, code = 0;
    if (k < len) {
      const uint32_t e = table[src[len - 1 - k]];
      nb = e >> 16;
      code = e & 0xFFFFu;
    }
    if (__any_sync(full, k < len && (nb == 0 || nb > 32))) {
      no_code = true;
      break;
    }
    if (nb < 32) code &= (1u << nb) - 1;
    uint32_t incl = nb;
#pragma unroll
    for (uint32_t d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(full, incl, d);
      if (lane >= d) incl += t;
    }
    const uint32_t step = __shfl_sync(full, incl, 31);
    // once over, only look for symbols without a code
    if (overflow || pos + step + 1 > limit) {
      overflow = true;
      continue;
    }
    const uint32_t r = static_cast<uint32_t>(pos & 31) + incl - nb;
    if (nb) {
      const uint32_t sh = r & 31, w = r >> 5;
      atomicOr(&win[w], code << sh);
      if (sh + nb > 32) atomicOr(&win[w + 1], code >> (32 - sh));
    }
    __syncwarp();
    const uint32_t done = (static_cast<uint32_t>(pos & 31) + step) >> 5;
    if (lane < done) out[(pos >> 5) + lane] = win[lane];
    const uint32_t carry = win[done];
    __syncwarp();
    if (lane < done) win[lane + 1] = 0;
    if (lane == 0) win[0] = carry;
    __syncwarp();
    pos += step;
  }
  if (no_code || overflow) {
    for (int64_t i = lane; i < cap; i += 32) out[i] = 0;
    if (lane == 0) {
      status[seg] = no_code ? kErrNoCode : kErrOverflow;
      bits[seg] = 0;
    }
    return;
  }
  if (lane == 0) {
    out[pos >> 5] = win[0] | (1u << (pos & 31));  // the end mark
    bits[seg] = pos;
    status[seg] = kOk;
  }
}

}  // namespace

extern "C" int huf_pack_launch(const uint8_t* data, int64_t n_data,
                               const int64_t* segs, int64_t n_seg,
                               const int32_t* tables, int64_t n_tables,
                               int32_t* words, int64_t n_words, int64_t* bits,
                               int32_t* status, void* stream) {
  const int64_t n_streams = n_seg / kSegments;
  if (n_streams <= 0) return 0;
  huf_pack_kernel<<<static_cast<unsigned>(n_streams), kSegments * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      data, n_data, segs, reinterpret_cast<const uint32_t*>(tables), n_tables,
      reinterpret_cast<uint32_t*>(words), n_words, bits, status);
  return static_cast<int>(cudaGetLastError());
}
