// enc_chain: the device encoder's hash-chain walk (levels x6-x9), on an
// H100 (sm_90a).
//
// Replaces the Pallas TPU kernel lizard_tpu/ops/enc_lanes.py::_p15_kernel
// (l.538, launched by p15_call l.705). Its contract, not its tiling, is the
// numpy mirror p15_reference (l.1981): per position p, from the map-0
// candidate cand, walk cur += delta[max(p - cur, 0)] for up to `chain`
// steps, stopping at the first step whose delta is 0 or whose distance
// passes maxoff; rank each node by its matched prefix with p, capped at
// `pref` bytes, the source clamped at 0; a node wins if it matches >= 4
// bytes and strictly more than the best so far (so the nearest node keeps
// ties; cand itself is ranked without the gate). The winner goes to map 0
// of the output, the delta map (the input's last map) is dropped, and maps
// 1..ncand-1 pass through. Bytes past the packed row read as zero.
//
// What bounds it on this card: not bytes (the block once, the candidate
// and delta maps read once and the output maps written once: for the 32 MB
// corpus at level 49 ~32 MB + 128 MB + 64 MB, ~67 us at 3.35 TB/s) but the
// walk: 13.4 nodes a position on that corpus, up to 64, each a dependent
// delta read and a prefix compare. The first version (one thread a
// position) ranked every node by a loop of up to 16 dependent single-byte
// loads through L1/L2 (two thirds of a walk's cycles, the delta loads the
// rest, clocked on an H100: PERF.md, B6), and a warp waited for its
// longest walk.
//
// Design:
// - A walk from p never reaches back more than 65535 positions (cand and
//   every distance it keeps fit 16 bits), so a CTA that walks a slice of
//   kSlice positions stages the delta map (uint16) and the row (with a zero
//   pad past the row) of the 64 KB before the slice and of the slice in
//   shared memory, 216 KB; every node is then shared-memory reads. The
//   slices of a block are neighbouring CTAs, so they share its window in
//   L2.
// - A node is first tested on one byte: it can win only if it matches byte
//   max(best, 3) of p. Only then is it ranked: two unaligned 8-byte reads
//   of the row (three aligned 8-byte loads, two funnel shifts) XORed with
//   p's first 16 bytes, held in two registers, the first set bit giving
//   the matched length. A walk ends once its best matches pref bytes (no
//   later node can match more), which leaves the output as it is.
// - Each warp walks a run of positions, a lane a walk at a time: once
//   kRefill lanes are idle, they take the run's next positions (a ballot,
//   map 0 handed out by shuffles from four 32-position loads ahead), so a
//   lane does not idle while another walks 64 nodes.
// The output is a new tensor (the wrapper allocates it), not map 0 in
// place.
//
// chain_walk_kernel<true> is the profiling instance: per slice, int64
// kProf fields (see kernel); the timed instance reads no clock.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRefill = 8;        // idle lanes that make a warp hand out
                                  // positions (1, 4, 12, 16, 24: slower)
constexpr int kSlice = 8192;      // positions a CTA walks
constexpr int kBack = 65536;      // how far back a walk reaches, at most
constexpr int kRowPad = 32;       // row bytes staged past the slice
constexpr int kProf = 6;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Shared memory: the delta window (kBack + kSlice uint16) and the row
// window (kBack + kSlice + kRowPad bytes).
constexpr int kRowOff = 2 * (kBack + kSlice);
constexpr int kSmem = kRowOff + kBack + kSlice + kRowPad;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// clock64 read once v is known: v is first stored to the thread's slot of
// `sink` (a store waits for its operand), then the clock is read.
__device__ __forceinline__ long long clock_after(int* sink, int v) {
  long long t;
  asm volatile(
      "st.volatile.shared.u32 [%1], %2;\n\t"
      "mov.u64 %0, %%clock64;"
      : "=l"(t)
      : "r"((unsigned)__cvta_generic_to_shared(sink)), "r"(v)
      : "memory");
  return t;
}

// The 8 little-endian bytes at byte k of the staged row, from the aligned
// words w0 = row8[k / 8] and w1 = row8[k / 8 + 1].
__device__ __forceinline__ uint64_t funnel8(uint64_t w0, uint64_t w1,
                                            int k) {
  const int s = (k & 7) * 8;
  return (w0 >> s) | ((w1 << 1) << (63 - s));
}

// Matched-prefix bytes of the staged row at src against p's bytes p0
// (p..p+7) and p1 (p+8..p+15), capped at pref (<= 16).
__device__ __forceinline__ int prefix_len(const uint64_t* row8, int src,
                                          uint64_t p0, uint64_t p1,
                                          int pref) {
  const int i = src >> 3;
  const uint64_t w0 = row8[i], w1 = row8[i + 1], w2 = row8[i + 2];
  const uint64_t x0 = funnel8(w0, w1, src) ^ p0;
  const uint64_t x1 = funnel8(w1, w2, src) ^ p1;
  const int n = x0 ? (__ffsll((long long)x0) - 1) >> 3
                   : x1 ? 8 + ((__ffsll((long long)x1) - 1) >> 3) : 16;
  return n < pref ? n : pref;
}

// Grid: B * ceil(n / kSlice) CTAs, slice s of block b at b * slices + s.
// kProfile: per slice, int64 kProf fields into prof: the lane slots of the
// walk loop (32 an iteration of a warp that had a walk); the cycles, summed
// over nodes, of reading the node's delta and of ranking it (each timed
// alone: the profiling instance waits for each before the clock); the
// nodes walked; the positions walked (cand > 0); the CTA's ns on the
// global timer.
template <bool kProfile>
__global__ void __launch_bounds__(kThreads, 1)
chain_walk_kernel(const uint8_t* __restrict__ data,
                  const uint16_t* __restrict__ maps, int n, int stride,
                  int nmaps, int ncand, int chain, int pref, int maxoff,
                  uint16_t* __restrict__ out, long long* __restrict__ prof) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long acc[kProf];
  __shared__ int sink[kProfile ? kThreads : 1];
  const long long ns0 = kProfile ? global_ns() : 0;
  const int slices = (n + kSlice - 1) / kSlice;
  const int b = blockIdx.x / slices;
  const int lo = (blockIdx.x % slices) * kSlice;
  const int hi = min(lo + kSlice, n);
  const int base = lo - kBack > 0 ? lo - kBack : 0;   // a multiple of 8
  uint16_t* dwin = reinterpret_cast<uint16_t*>(smem);
  uint64_t* row8 = reinterpret_cast<uint64_t*>(smem + kRowOff);
  const uint16_t* mrow = maps + (size_t)b * nmaps * n;
  const uint16_t* delta = mrow + (size_t)(nmaps - 1) * n;
  if (kProfile && threadIdx.x < kProf) acc[threadIdx.x] = 0;
  {
    // the delta window [base, hi), 16 bytes a load (base % 8 == 0)
    const uint4* g = reinterpret_cast<const uint4*>(delta + base);
    uint4* s = reinterpret_cast<uint4*>(dwin);
    for (int k = threadIdx.x; k < (hi - base) / 8; k += kThreads)
      s[k] = __ldg(g + k);
    // the row window [base, hi + kRowPad): stride = n + 8 bytes, a
    // multiple of 8; zeros past it
    const uint64_t* g8 =
        reinterpret_cast<const uint64_t*>(data + (size_t)b * stride + base);
    const int have = (stride - base) / 8;
    for (int k = threadIdx.x; k < (hi + kRowPad - base) / 8; k += kThreads)
      row8[k] = k < have ? __ldg(g8 + k) : 0;
  }
  __syncthreads();

  uint16_t* orow = out + (size_t)b * ncand * n;
  int* my_sink = sink + (kProfile ? threadIdx.x : 0);
  long long t_delta = 0, t_rank = 0, nodes = 0, walks = 0, slots = 0;
  // Each warp walks a run of `per` positions, a lane a walk at a time:
  // once kRefill lanes have ended their walks (or all have), they take the
  // warp's next positions, so lanes do not idle while another walks 64
  // nodes. Map 0 of the run is read 32 positions a load, four loads ahead
  // (c0..c3, chunks j..j+3), and handed out by shuffles.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (hi - lo) / (kThreads / 32);    // a multiple of 4
  const int wlo = lo + warp * per;
  auto chunk = [&](int j) {
    const int o = 32 * j + lane;
    return o < per ? (int)__ldg(mrow + wlo + o) : 0;
  };
  int c0 = chunk(0), c1 = chunk(1), c2 = chunk(2), c3 = chunk(3);
  int j = 0, next = 0;          // next: the run's next position to hand out
  // a walk ends once its best matches `lim` bytes: no later node can match
  // more (below 4 bytes no node wins at all)
  const int lim = pref < 4 ? 0 : pref;
  const uint8_t* rowb = reinterpret_cast<const uint8_t*>(row8);
  int p = -1, cur = 0, nd = 0, best_d = 0, best_l = 0, steps = 0;
  uint64_t p0 = 0, p1 = 0;
  while (true) {
    const unsigned idle = __ballot_sync(kFull, p < 0);
    if (next < per && (__popc(idle) >= kRefill || idle == kFull)) {
      const int o = next + __popc(idle & ((1u << lane) - 1));
      const int in0 = __shfl_sync(kFull, c0, o & 31);
      const int in1 = __shfl_sync(kFull, c1, o & 31);
      if (p < 0 && o < per) {
        const int cand = (o >> 5) == j ? in0 : in1;
        p = wlo + o;
        if (cand == 0) {
          orow[p] = 0;
          p = -1;
        } else {
          const int x = p - base;               // p in the windows
          const int i = x >> 3;
          const uint64_t w0 = row8[i], w1 = row8[i + 1], w2 = row8[i + 2];
          p0 = funnel8(w0, w1, x);
          p1 = funnel8(w1, w2, x);
          const int src = (p - cand > 0 ? p - cand : 0) - base;
          cur = best_d = cand;
          steps = 0;
          nd = dwin[src];
          best_l = prefix_len(row8, src, p0, p1, pref);
          if (kProfile) ++walks;
        }
      }
      next += __popc(idle);
      if ((next >> 5) > j) {
        c0 = c1;
        c1 = c2;
        c2 = c3;
        c3 = chunk(j + 4);
        ++j;
      }
    }
    if (!__any_sync(kFull, p >= 0)) {
      if (next >= per) break;
      continue;
    }
    if (kProfile && lane == 0) slots += 32;
    if (p >= 0) {
      const int cur2 = cur + nd;
      if (steps == chain || nd == 0 || cur2 > maxoff || best_l >= lim) {
        orow[p] = (uint16_t)best_d;
        p = -1;
      } else {
        const int src = (p - cur2 > 0 ? p - cur2 : 0) - base;
        const long long u0 = kProfile ? clock_after(my_sink, cur2) : 0;
        nd = dwin[src];
        const long long u1 = kProfile ? clock_after(my_sink, nd) : 0;
        // the node can win only if its byte f matches too: one byte read
        // before the 16
        const int f = best_l > 3 ? best_l : 3;
        const int pf = (int)((f < 8 ? p0 >> (8 * f) : p1 >> (8 * f - 64)) &
                             0xFF);
        if (rowb[src + f] == pf) {
          const int ln = prefix_len(row8, src, p0, p1, pref);
          if (ln >= 4 && ln > best_l) {
            best_d = cur2;
            best_l = ln;
          }
        }
        if (kProfile) {
          t_delta += u1 - u0;
          t_rank += clock_after(my_sink, best_l) - u1;
          ++nodes;
        }
        cur = cur2;
        ++steps;
      }
    }
  }
  // maps 1..ncand-1 pass through, 16 bytes a thread (lo % 8 == 0)
  for (int m = 1; m < ncand; ++m) {
    const uint4* src =
        reinterpret_cast<const uint4*>(mrow + (size_t)m * n + lo);
    uint4* dst = reinterpret_cast<uint4*>(orow + (size_t)m * n + lo);
    for (int k = threadIdx.x; k < (hi - lo) / 8; k += kThreads)
      dst[k] = __ldg(src + k);
  }
  if (kProfile) {
    atomicAdd(&acc[0], (unsigned long long)slots);
    atomicAdd(&acc[1], (unsigned long long)t_delta);
    atomicAdd(&acc[2], (unsigned long long)t_rank);
    atomicAdd(&acc[3], (unsigned long long)nodes);
    atomicAdd(&acc[4], (unsigned long long)walks);
    __syncthreads();
    if (threadIdx.x == 0) {
      long long* pr = prof + (size_t)blockIdx.x * kProf;
      for (int f = 0; f < kProf - 1; ++f) pr[f] = (long long)acc[f];
      pr[kProf - 1] = global_ns() - ns0;
    }
  }
}

}  // namespace

// CTAs of one launch for B blocks of n positions (the profile's rows).
extern "C" int chain_walk_ctas(int B, int n) {
  return B * ((n + kSlice - 1) / kSlice);
}

// data: (B, stride) uint8 rows, 8-byte aligned, stride = n + 8; maps: (B,
// nmaps, n) uint16, 16-byte aligned, n a multiple of 128; out: (B, ncand,
// n) uint16, 16-byte aligned; pref <= 16; prof: null, or
// (chain_walk_ctas(B, n), 6) int64 for the profiling instance. Returns the
// launch's cudaError_t.
extern "C" int chain_walk_launch(const void* data, const void* maps, int B,
                                 int n, int stride, int nmaps, int ncand,
                                 int chain, int pref, int maxoff, void* out,
                                 void* prof, void* stream) {
  const auto kernel =
      prof ? chain_walk_kernel<true> : chain_walk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<chain_walk_ctas(B, n), kThreads, kSmem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint16_t*)maps, n, stride, nmaps, ncand,
      chain, pref, maxoff, (uint16_t*)out, (long long*)prof);
  return (int)cudaGetLastError();
}
