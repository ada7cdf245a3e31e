// The first designs of the device encoder's match_find and chain_walk (the
// port's csrc/enc_match.cu and csrc/enc_chain.cu before their redesign for
// Hopper), with clocks, so that what set their time can be measured beside the
// redesigned kernels. Built and driven by tools/enc_v1_profile.py; the
// package never launches them.
//
// match_find_v1: one 128-thread CTA a block looping over its segments. Per
// block, int64 fields: the block's cycles; thread 0's cycles in (A) its
// lookups, verify, probe ladder, chk13 and map stores, (B) the wait at the
// first barrier for the segment's slowest lane, (C) the insert (raw keys,
// keep rule, the 128-wide duplicate count, the writes and the other two
// barriers); the block's ns on the global timer.
//
// chain_walk_v1: one thread a position. Per block of the batch, int64
// fields summed over its positions: the cycles of every walked position,
// of which waiting for delta loads, of which ranking nodes (the byte loop);
// the nodes walked; the positions walked; 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kMaxProbes = 16;
constexpr int kMfLimit = 20;
constexpr int kMinLength = 21;
constexpr uint32_t kHmul = 2654435761u;
constexpr uint32_t kH5Mix = 0x9E3Bu;
constexpr uint32_t kChk1 = 0x85EBCA6Bu;
constexpr uint32_t kChk2 = 0xC2B2AE3Du;
constexpr uint32_t kChk3 = 668265263u;

struct Cfg {
  int n, stride, hl, maxoff, min_offset, k5, far, far_dist, chain, nmaps,
      nprobes;
  int probes[kMaxProbes];
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long clock_after(int v) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(v) : "memory");
  return t;
}

__device__ __forceinline__ uint32_t w8_at(const uint8_t* row, int p) {
  return (uint32_t)row[p] | ((uint32_t)row[p + 1] << 8) |
         ((uint32_t)row[p + 2] << 16) | ((uint32_t)row[p + 3] << 24);
}

__device__ __forceinline__ int hash_of(uint32_t w, int shift) {
  return (int)((w * kHmul) >> shift);
}

__device__ __forceinline__ int chk13(const uint8_t* row, int seg, int l) {
  const int base = seg * kSeg;
  const uint32_t mix = w8_at(row, base + l) ^
                       (w8_at(row, base + ((l + 4) & 127)) * kChk1) ^
                       (w8_at(row, base + ((l + 8) & 127)) * kChk2) ^
                       (w8_at(row, base + ((l + 12) & 127)) * kChk3);
  return (int)(((mix * kHmul) >> 19) & 8191);
}

__device__ __forceinline__ int verified(const int* tab, int h, int p,
                                        uint32_t w, const uint8_t* row,
                                        const Cfg& c) {
  const int v = tab[h];
  const int c0 = v - 1;
  const int off = p - c0;
  if (v > 0 && off >= c.min_offset && off <= c.maxoff &&
      w8_at(row, c0) == w)
    return c0;
  return -1;
}

__device__ __forceinline__ void keep_key(int* keys, const int* raw, int l,
                                         bool valid) {
  const int h = raw[l];
  const bool keep = valid && (l == kSeg - 1 || h != raw[l + 1]);
  keys[l] = keep ? h : -1;
}

__device__ __forceinline__ void insert_unique(int* tab, const int* keys,
                                              int l, int val) {
  const int h = keys[l];
  if (h < 0) return;
  int count = 0;
  for (int k = 0; k < kSeg; ++k) count += keys[k] == h;
  if (count == 1) tab[h] = val;
}

__global__ void __launch_bounds__(kSeg)
match_find_v1(const uint8_t* __restrict__ data,
              const int32_t* __restrict__ lens, Cfg c,
              uint16_t* __restrict__ maps, int32_t* gtab,
              long long* __restrict__ prof) {
  extern __shared__ int smem[];
  const long long t_start = clock64();
  const long long ns_start = global_ns();
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const uint8_t* row = data + (size_t)b * c.stride;
  const int len = lens[b];
  const int tsize = 1 << c.hl;
  const int ntab = 1 + c.k5 + (c.far ? 1 : 0);
  int* tab = gtab ? gtab + (size_t)b * ntab * tsize : smem;
  int* keys = gtab ? smem : smem + ntab * tsize;
  int* raw4 = keys;
  int* raw5 = keys + kSeg;
  int* rawf = keys + 2 * kSeg;
  int* key4 = keys + 3 * kSeg;
  int* key5 = keys + 4 * kSeg;
  int* keyf = keys + 5 * kSeg;
  for (int k = l; k < ntab * tsize; k += kSeg) tab[k] = 0;
  __syncthreads();

  uint16_t* out = maps + (size_t)b * c.nmaps * c.n;
  const int shift = 32 - c.hl;
  const int far_seg = c.far_dist / kSeg;
  const int FD = c.far_dist;
  const bool len_ok = len >= kMinLength;
  int* tab_far = tab + (1 + c.k5) * tsize;
  long long ta = 0, tb = 0, tc = 0;
  for (int i = 0; i < c.n / kSeg; ++i) {
    const long long t0 = clock64();
    const int p = i * kSeg + l;
    const uint32_t w = w8_at(row, p);
    const int h = hash_of(w, shift);
    int h5 = 0;
    if (c.k5) h5 = hash_of(w ^ ((uint32_t)row[p + 4] * kH5Mix), shift);
    const int v4 = tab[h];
    int best = verified(tab, h, p, w, row, c);
    for (int k = 0; k < c.nprobes && best < 0; ++k) {
      const int q = p - c.probes[k];
      if (q >= 0 && w8_at(row, q) == w) best = q;
    }
    const bool emit_ok = len_ok && p < len - kMfLimit;
    int m = 0;
    if (c.k5 == 1) {
      const int c5 = verified(tab + tsize, h5, p, w, row, c);
      if (c5 >= 0) best = c5;
    }
    out[(size_t)(m++) * c.n + p] =
        (uint16_t)(emit_ok && best >= 0 ? p - best : 0);
    if (c.k5 >= 2) {
      for (int j = 0; j < c.k5; ++j) {
        const int c5 = verified(tab + (1 + j) * tsize, h5, p, w, row, c);
        out[(size_t)(m++) * c.n + p] =
            (uint16_t)(emit_ok && c5 >= 0 ? p - c5 : 0);
      }
    }
    if (c.far) {
      const int vF = tab_far[h];
      const int offF = p - ((vF >> 13) - 1);
      const bool okF = vF > 0 && (vF & 8191) == chk13(row, i, l) &&
                       offF >= FD && offF <= 2 * FD - 2;
      out[(size_t)(m++) * c.n + p] =
          (uint16_t)(emit_ok && okF ? offF - (FD - 1) : 0);
    }
    if (c.chain) {
      const int dl = p - (v4 - 1);
      out[(size_t)(m++) * c.n + p] =
          (uint16_t)(v4 > 0 && dl < (1 << 16) ? dl : 0);
    }
    const bool do_far = c.far && i >= far_seg;
    const int q = p - FD;
    raw4[l] = h;
    if (c.k5) raw5[l] = h5;
    if (do_far) rawf[l] = hash_of(w8_at(row, q), shift);
    const long long t1 = clock_after(best + m);
    __syncthreads();
    const long long t2 = clock64();
    keep_key(key4, raw4, l, p < len);
    if (c.k5) keep_key(key5, raw5, l, p < len);
    if (do_far) keep_key(keyf, rawf, l, q < len);
    __syncthreads();
    insert_unique(tab, key4, l, p + 1);
    if (c.k5) insert_unique(tab + (1 + (i & (c.k5 - 1))) * tsize, key5, l,
                            p + 1);
    if (do_far)
      insert_unique(tab_far, keyf, l,
                    ((q + 1) << 13) | chk13(row, i - far_seg, l));
    __syncthreads();
    const long long t3 = clock64();
    ta += t1 - t0;
    tb += t2 - t1;
    tc += t3 - t2;
  }
  if (l == 0) {
    long long* pr = prof + (size_t)b * 5;
    pr[0] = clock64() - t_start;
    pr[1] = ta;
    pr[2] = tb;
    pr[3] = tc;
    pr[4] = global_ns() - ns_start;
  }
}

constexpr int kThreads = 256;

__device__ __forceinline__ int byte_at(const uint8_t* row, int k,
                                       int stride) {
  return k < stride ? __ldg(row + k) : 0;
}

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
chain_walk_v1(const uint8_t* __restrict__ data,
              const uint16_t* __restrict__ maps, int B, int n, int stride,
              int nmaps, int ncand, int chain, int pref, int maxoff,
              uint16_t* __restrict__ out, long long* __restrict__ prof) {
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
  long long t_all = 0, t_delta = 0, t_rank = 0, nodes = 0;
  if (cand > 0) {
    const long long t0 = clock_after(cand);
    int best_l = prefix_len(row, p, cand, pref, stride);
    long long t = clock_after(best_l);
    t_rank += t - t0;
    int cur = cand;
    for (int s = 0; s < chain; ++s) {
      const int q = p - cur > 0 ? p - cur : 0;
      const int nd = __ldg(delta + q);
      const int cur2 = cur + nd;
      long long u = clock_after(cur2);
      t_delta += u - t;
      t = u;
      if (nd == 0 || cur2 > maxoff) break;
      const int ln = prefix_len(row, p, cur2, pref, stride);
      if (ln >= 4 && ln > best_l) {
        best_d = cur2;
        best_l = ln;
      }
      u = clock_after(best_l);
      t_rank += u - t;
      t = u;
      ++nodes;
      cur = cur2;
    }
    t_all = t - t0;
  }
  orow[p] = (uint16_t)best_d;
  for (int m = 1; m < ncand; ++m)
    orow[(size_t)m * n + p] = __ldg(mrow + (size_t)m * n + p);
  long long* pr = prof + (size_t)b * 6;
  if (cand > 0) {
    atomicAdd((unsigned long long*)pr + 0, (unsigned long long)t_all);
    atomicAdd((unsigned long long*)pr + 1, (unsigned long long)t_delta);
    atomicAdd((unsigned long long*)pr + 2, (unsigned long long)t_rank);
    atomicAdd((unsigned long long*)pr + 3, (unsigned long long)nodes);
    atomicAdd((unsigned long long*)pr + 4, 1ull);
  }
}

}  // namespace

// Ints of global table scratch a block needs (0: the tables go in shared
// memory), by the first design's rule: the tables sit beside the 6 x 128
// keys in shared memory when both fit in the card's opt-in limit.
extern "C" long long match_find_v1_scratch_ints(int ntab, int hl) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  const long long tab = (long long)ntab << hl;
  return 6 * kSeg * (long long)sizeof(int) + tab * (long long)sizeof(int) <=
                 limit
             ? 0
             : tab;
}

// As the first design's match_find_launch, with prof: (B, 5) int64.
extern "C" int match_find_v1_launch(const void* data, const void* lens,
                                    int B, const int32_t* v, void* maps,
                                    void* scratch, void* prof,
                                    void* stream) {
  Cfg c;
  c.n = v[0];
  c.stride = v[1];
  c.hl = v[2];
  c.maxoff = v[3];
  c.min_offset = v[4];
  c.k5 = v[5];
  c.far = v[6];
  c.far_dist = v[7];
  c.chain = v[8];
  c.nmaps = v[9];
  c.nprobes = v[10];
  for (int k = 0; k < kMaxProbes; ++k) c.probes[k] = v[11 + k];
  const int ntab = 1 + c.k5 + (c.far ? 1 : 0);
  size_t smem = 6 * kSeg * sizeof(int);
  if (scratch == nullptr) smem += (size_t)ntab * (1u << c.hl) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      match_find_v1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_find_v1<<<B, kSeg, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, c, (uint16_t*)maps,
      (int32_t*)scratch, (long long*)prof);
  return (int)cudaGetLastError();
}

// As the first design's chain_walk_launch, with prof: (B, 6) int64, zeroed.
extern "C" int chain_walk_v1_launch(const void* data, const void* maps,
                                    int B, int n, int stride, int nmaps,
                                    int ncand, int chain, int pref,
                                    int maxoff, void* out, void* prof,
                                    void* stream) {
  const int64_t total = (int64_t)B * n;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  chain_walk_v1<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint16_t*)maps, B, n, stride, nmaps,
      ncand, chain, pref, maxoff, (uint16_t*)out, (long long*)prof);
  return (int)cudaGetLastError();
}
