// enc_chain: the device encoder's hash-chain walk (levels x6-x9), on an
// H100 (sm_90a).
//
// Replaces the Pallas TPU kernel lizard_tpu/ops/enc_lanes.py::_p15_kernel
// (l.538, launched by p15_call l.705). Its contract, not its tiling, is the
// numpy mirror p15_reference (l.1981): per position p, from the map-0
// candidate cand, walk cur += delta[p - cur] for up to `chain` steps,
// stopping at the first step whose delta is 0 or whose distance passes
// maxoff; rank each node by its matched prefix with p, capped at `pref`
// bytes; a node wins if it matches >= 4 bytes and strictly more than the
// best so far (so the nearest node keeps ties; cand itself is ranked without
// the gate). The winner goes to map 0 of the output, the delta map (the
// input's last map) is dropped, and maps 1..ncand-1 pass through. Bytes past
// the packed row read as zero.
//
// What bounds it on this card: bytes, at the floor: the block once, the
// candidate and delta maps read once and the output maps written once; for
// the 32 MB corpus at level 49 ~32 MB + 128 MB + 64 MB, ~67 us at 3.35 TB/s.
// The walk is a chain of dependent loads (delta, then up to pref bytes at
// the node), up to 64 deep at level 49, so latency, not bandwidth, sets the
// time; a whole card of independent positions (33 M at full width) hides
// much of it.
//
// Design, a first version: one thread per position, no shared memory; bytes
// and deltas are read through the read-only cache. The output is a new
// tensor (the wrapper allocates it), not map 0 in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int byte_at(const uint8_t* row, int k,
                                       int stride) {
  return k < stride ? __ldg(row + k) : 0;
}

// Matched-prefix bytes of p against p - dist (dist > 0), capped at pref.
__device__ __forceinline__ int prefix_len(const uint8_t* row, int p, int dist,
                                          int pref, int stride) {
  const int src = p - dist > 0 ? p - dist : 0;
  int n = 0;
  while (n < pref && byte_at(row, src + n, stride) ==
                         byte_at(row, p + n, stride))
    ++n;
  return n;
}

__global__ void __launch_bounds__(kThreads)
chain_walk_kernel(const uint8_t* __restrict__ data,
                  const uint16_t* __restrict__ maps, int B, int n,
                  int stride, int nmaps, int ncand, int chain, int pref,
                  int maxoff, uint16_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)B * n) return;
  const int b = (int)(idx / n);
  const int p = (int)(idx % n);
  const uint8_t* row = data + (size_t)b * stride;
  const uint16_t* mrow = maps + (size_t)b * nmaps * n;
  const uint16_t* delta = mrow + (size_t)(nmaps - 1) * n;
  uint16_t* orow = out + (size_t)b * ncand * n;

  const int cand = __ldg(mrow + p);
  int best_d = cand;
  if (cand > 0) {
    int best_l = prefix_len(row, p, cand, pref, stride);
    int cur = cand;
    for (int s = 0; s < chain; ++s) {
      const int q = p - cur > 0 ? p - cur : 0;
      const int nd = __ldg(delta + q);
      const int cur2 = cur + nd;
      if (nd == 0 || cur2 > maxoff) break;
      const int ln = prefix_len(row, p, cur2, pref, stride);
      if (ln >= 4 && ln > best_l) {
        best_d = cur2;
        best_l = ln;
      }
      cur = cur2;
    }
  }
  orow[p] = (uint16_t)best_d;
  for (int m = 1; m < ncand; ++m)
    orow[(size_t)m * n + p] = __ldg(mrow + (size_t)m * n + p);
}

}  // namespace

// data: (B, stride) uint8 rows; maps: (B, nmaps, n) uint16; out: (B, ncand,
// n) uint16. Returns the launch's cudaError_t.
extern "C" int chain_walk_launch(const void* data, const void* maps, int B,
                                 int n, int stride, int nmaps, int ncand,
                                 int chain, int pref, int maxoff, void* out,
                                 void* stream) {
  const int64_t total = (int64_t)B * n;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  chain_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint16_t*)maps, B, n, stride, nmaps,
      ncand, chain, pref, maxoff, (uint16_t*)out);
  return (int)cudaGetLastError();
}
