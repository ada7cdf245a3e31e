// The first design of huf_pack (the port's csrc/huf_encode.cu before its
// redesign for Hopper), with clocks, so that what set its time can be
// measured beside the redesigned kernel. Built and driven by
// tools/huf_pack_ab.py; the package never launches it.
//
// One thread block per stream, one warp per segment (4 warps). Per step the
// warp's 32 lanes look up 32 symbols, a warp inclusive scan
// (__shfl_up_sync) gives each its bit offset from the segment's running
// position, the lanes OR their codes into the warp's window of words in
// shared memory, and the words the step completed go out to global memory;
// the partial last word becomes the window's first. The next step's
// position depends on every code before it: a segment is one serial chain
// of ceil(len / 32) steps.
//
// huf_pack_v1_kernel<true> also writes, per segment (warp), int64 fields:
// the steps it ran, lane 0's clock64 cycles and the card's global-timer ns
// from the warp's start to its end.

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
constexpr int kProfFields = 3;

// status codes, shared with lizard_tpu_torch/ops/enc_huf.py
constexpr int kOk = 0;
constexpr int kErrNoCode = -1;
constexpr int kErrOverflow = -2;
constexpr int kErrBounds = -3;

__host__ __device__ __forceinline__ int64_t segment_words(int64_t len) {
  return (len * kMaxBits + 31) / 32 + 1;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kProf>
__global__ void __launch_bounds__(kSegments * 32)
huf_pack_v1_kernel(const uint8_t* __restrict__ data, int64_t n_data,
                   const int64_t* __restrict__ segs,
                   const uint32_t* __restrict__ tables, int64_t n_tables,
                   uint32_t* __restrict__ words, int64_t n_words,
                   int64_t* __restrict__ bits, int32_t* __restrict__ status,
                   int64_t* __restrict__ prof) {
  __shared__ uint32_t table[kTableEntries];
  __shared__ uint32_t window[kSegments][kWindow];
  const int warp = threadIdx.x / 32;
  const uint32_t lane = threadIdx.x % 32;
  const unsigned full = 0xFFFFFFFFu;
  long long c0 = 0, n0 = 0;
  if (kProf && lane == 0) {
    n0 = global_ns();
    c0 = clock64();
  }
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
  int64_t steps = 0;
  bool no_code = false, overflow = false;
  for (int64_t k0 = 0; k0 < len; k0 += 32) {
    ++steps;
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
  } else if (lane == 0) {
    out[pos >> 5] = win[0] | (1u << (pos & 31));  // the end mark
    bits[seg] = pos;
    status[seg] = kOk;
  }
  if (kProf && lane == 0) {
    int64_t* p = prof + seg * kProfFields;
    p[0] = steps;
    p[1] = clock64() - c0;
    p[2] = global_ns() - n0;
  }
}

}  // namespace

// prof: nullptr for the first design as it was, else int64 (n_seg, 3).
extern "C" int huf_pack_v1_launch(const uint8_t* data, int64_t n_data,
                                  const int64_t* segs, int64_t n_seg,
                                  const int32_t* tables, int64_t n_tables,
                                  int32_t* words, int64_t n_words,
                                  int64_t* bits, int32_t* status,
                                  int64_t* prof, void* stream) {
  const int64_t n_streams = n_seg / kSegments;
  if (n_streams <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(tables);
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  if (prof)
    huf_pack_v1_kernel<true><<<static_cast<unsigned>(n_streams),
                               kSegments * 32, 0, s>>>(
        data, n_data, segs, tab, n_tables, w, n_words, bits, status, prof);
  else
    huf_pack_v1_kernel<false><<<static_cast<unsigned>(n_streams),
                                kSegments * 32, 0, s>>>(
        data, n_data, segs, tab, n_tables, w, n_words, bits, status, nullptr);
  return static_cast<int>(cudaGetLastError());
}
