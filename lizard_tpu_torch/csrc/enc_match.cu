// enc_match: the device encoder's match finder, on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel lizard_tpu/ops/enc_lanes.py::_p1_kernel
// (l.219, launched by p1_call l.485). Its contract, not its tiling, is the
// numpy mirror p1_reference (l.1847): per position p of a block, in
// segments of 128 positions,
// - lookup: the h4 table (and the k5 h5 tables) give the bucket's previous
//   occupant c, verified by a 4-byte compare and min_offset <= p-c <= maxoff;
// - the probe ladder p-d, d in cfg.probes in order, fills an h4 miss: the
//   first 4-byte hit wins;
// - k5 == 1: a verified h5 candidate overrides map 0; k5 >= 2: each h5 slot
//   is its own map;
// - far (LIZv1): the far table, whose inserts run far_dist bytes late, holds
//   ((pos+1) << 13) | chk13; a lookup with the same checksum at distance
//   [far_dist, 2*far_dist-2] gives raw = distance - (far_dist-1);
// - chain tiers: the delta map, p minus the h4 bucket's occupant before this
//   segment's insert, unverified, 0 if >= 65536;
// - maps are 0 where p >= len - MFLIMIT or len < LIZARD_MIN_LENGTH (the delta
//   map excepted);
// - then the segment's insert: a lane is kept if it is lane 127 or its
//   bucket differs from lane l+1's, and p < len; a bucket hit by exactly one
//   kept lane takes pos+1, one hit by two or more keeps its old entry. The k5
//   insert goes to slot i & (k5-1). Every lookup of segment i sees the tables
//   after segment i-1's inserts.
// chk13 mixes the words at lanes l+4, l+8, l+12 circularly within the
// position's 128-byte segment: a TPU lane-roll artifact that is part of the
// contract.
//
// What bounds it on this card: not bytes (the block read once, nmaps uint16
// maps written once: for the 32 MB corpus at level 11, 32 MB in and 64 MB
// out, ~29 us at 3.35 TB/s) but the table state, which is serial: segment i
// looks up what segment i-1 inserted, 1024 segments a 128 KB block. The
// first version ran everything inside that serial loop, one 128-thread CTA
// a block: words built from single-byte loads, the probe ladder one probe
// at a time, chk13, a 128-wide duplicate count per kept lane, three
// barriers a segment, and the map stores (clocked on an H100, PERF.md,
// B5: the lookups, verify, probes and stores took 62-74% of a segment, the
// insert with its count 25-37%).
//
// Design: only the tables are serial, so only table work stays in the
// loop. One 32-warp CTA a block, warp-specialised, in lockstep stages of S
// segments (a chunk; __syncthreads between stages):
// - the 28 worker warps copy each chunk's row window (the chunk and the
//   probe ladder's reach before it) into shared memory with cp.async, two
//   stages ahead, and compute, a chunk ahead, each segment's keys (a warp a
//   segment): the words (two 4-byte reads of the window a lane), h4, h5,
//   the keep rule (a shuffle) and the unique-bucket rule (a per-warp bitmap
//   of 2^hl bits: atomicOr, then duplicates clear their bit; O(1) a key),
//   and for the far table the same of the segment far_dist back (from
//   global memory), with its chk13 (shuffles);
// - 4 table warps, one thread a lane, run the loop on the previous chunk:
//   per segment, read the keys from shared memory, look up every table,
//   store the raw entries (16-bit distances; the far entry whole) into a
//   ring, a named barrier, the unique inserts (they cannot conflict), a
//   named barrier. No global load in the loop;
// - the worker warps verify, two chunks behind, from the ring and the
//   chunk's window: the candidates' 4-byte compares (their words loaded
//   together from global memory, up to 64 KB back), the probe ladder
//   unrolled over every probe, the k5 override or slots, the far checksum
//   and range, emit_ok, the ungated delta map, and the map stores,
//   neighbouring positions in neighbouring lanes.
// The tables live in shared memory with 4-byte entries where they fit (hl
// 13 with up to six tables, hl 15 with one); with 3-byte entries (a 16-bit
// and an 8-bit plane) at hl 16 with one table (levels x8-x9), which costs a
// second wave of CTAs (one CTA an SM) but keeps the loop off L2; else (hl
// 16 with several tables) in a per-block slice of a global scratch buffer
// that the wrapper allocates (match_find_table_bytes). S is the largest of
// 8, 4, 2, 1 whose rings fit beside the tables.
//
// match_find_kernel<.., true> is the profiling instance: per block, int64
// kProf fields (see kernel); the timed instance reads no clock.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kTableWarps = 4;       // one thread per lane of a segment
constexpr int kWorkWarps = 28;
constexpr int kThreads = (kTableWarps + kWorkWarps) * 32;
constexpr int kMaxProbes = 16;
constexpr int kMaxChunk = 8;         // segments a stage, one key warp each
constexpr int kWindows = 5;          // row windows: chunks k+2 (filling),
                                     // k+1, k (keys), k-1 and k-2 (verify)
static_assert(kMaxChunk <= kWorkWarps, "a stage's keys take a warp each");
constexpr int kSmemLimit = 232448 - 1024;   // a CTA's dynamic shared memory
                                            // (its static kept below 1 KB)
constexpr int kMfLimit = 20;         // MFLIMIT
constexpr int kMinLength = 21;       // LIZARD_MIN_LENGTH
constexpr uint32_t kHmul = 2654435761u;
constexpr uint32_t kH5Mix = 0x9E3Bu;
constexpr uint32_t kChk1 = 0x85EBCA6Bu;
constexpr uint32_t kChk2 = 0xC2B2AE3Du;
constexpr uint32_t kChk3 = 668265263u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kProf = 7;

// The layout of the int32 parameter array the wrapper passes
// (lizard_tpu_torch/ops/enc_lanes.py::_match_params).
struct Cfg {
  int n, stride, hl, maxoff, min_offset, k5, far, far_dist, chain, nmaps,
      nprobes;
  int probes[kMaxProbes];
};

// Where the tables live: shared memory with 4-byte entries; shared memory
// with 3-byte entries (a 16-bit plane and an 8-bit plane: hl 16 with one
// table, 192 KB, no far table, whose entries take 31 bits); global memory.
enum Place { kShared32, kShared24, kGlobal32 };

// Byte offsets of one CTA's shared memory: the tables (when shared), the
// key rings (lookup buckets, insert words; 2 x S x 128 uint32 each), the
// raw rings (2 x (1 + k5) x S x 128 uint16 distances, 2 x S x 128 uint32
// far entries), one bucket bitmap per key warp (S x 2^hl bits) and the row
// windows (kWindows x (the longest probe + S x 128 + 16) bytes).
struct Layout {
  int ntab, S, back, wlen;
  Place place;
  size_t look, ins, rawd, rawf, bits, win, total;
};

__host__ __device__ inline Layout layout(const Cfg& c, int S, Place place) {
  Layout L;
  L.ntab = 1 + c.k5 + (c.far ? 1 : 0);
  L.S = S;
  L.place = place;
  const size_t ring = (size_t)S * kSeg;
  const int entry = place == kShared32 ? 4 : place == kShared24 ? 3 : 0;
  size_t at = ((size_t)L.ntab * entry << c.hl) + 15 & ~(size_t)15;
  L.look = at;
  at += 2 * ring * 4;
  L.ins = at;
  at += 2 * ring * 4;
  L.rawf = at;
  at += c.far ? 2 * ring * 4 : 0;
  L.rawd = at;
  at += 2 * (size_t)(1 + c.k5) * ring * 2;
  at = (at + 15) & ~(size_t)15;
  L.bits = at;
  at += (size_t)S << (c.hl - 3);
  // the row windows: the chunk's bytes, the probe ladder's reach before
  // them, and 16 bytes after (kWindows buffers)
  int back = 16;
  for (int k = 0; k < c.nprobes; ++k)
    back = c.probes[k] > back ? c.probes[k] : back;
  L.back = (back + 15) & ~15;
  L.wlen = L.back + (int)ring + 16;
  L.win = at;
  at += kWindows * (size_t)L.wlen;
  L.total = at;
  return L;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 8 bytes from global to shared memory without a register, or 8 zero
// bytes when !valid (src is then any readable address).
__device__ __forceinline__ void copy8_async(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// Closes the thread's group of copies issued since the last commit.
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void table_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTableWarps * 32) : "memory");
}

// The 4 little-endian bytes at y (y + 3 < stride: rows are padded), from
// two aligned 4-byte loads (rows are 8-byte aligned).
__device__ __forceinline__ uint32_t word_at(const uint32_t* row32, int y) {
  return __funnelshift_r(__ldg(row32 + (y >> 2)), __ldg(row32 + (y >> 2) + 1),
                         8 * (y & 3));
}

__device__ __forceinline__ int hash_of(uint32_t w, int shift) {
  return (int)((w * kHmul) >> shift);
}

__device__ __forceinline__ int chk_mix(uint32_t w0, uint32_t w4, uint32_t w8,
                                       uint32_t w12) {
  const uint32_t mix = w0 ^ (w4 * kChk1) ^ (w8 * kChk2) ^ (w12 * kChk3);
  return (int)(((mix * kHmul) >> 19) & 8191);
}

// The 16-bit distance from p to a table entry v (pos + 1, 0 = empty): 0 if
// empty or >= 65536. Entries come from earlier segments, so it is >= 1.
__device__ __forceinline__ uint16_t dist16(int p, int v) {
  const int d = p - (v - 1);
  return (uint16_t)(v > 0 && d < (1 << 16) ? d : 0);
}

// The keys of one segment, computed by one warp, lane L holding positions
// 4L..4L+3 of it.
struct SegKeys {
  int p[4];
  uint32_t w[4];
  int h[4], h5[4];
};

// From the 4-byte words w32, whose word 0 holds byte s0 of the row.
__device__ __forceinline__ void seg_words(const uint32_t* w32, int s0,
                                          int seg, int L, int shift,
                                          SegKeys& k) {
  const int base = seg * kSeg + 4 * L;
  const uint32_t a = w32[(base - s0) >> 2];
  const uint32_t b = w32[((base - s0) >> 2) + 1];
  for (int j = 0; j < 4; ++j) {
    k.p[j] = base + j;
    k.w[j] = __funnelshift_r(a, b, 8 * j);
    k.h[j] = hash_of(k.w[j], shift);
    const uint32_t b4 = (b >> (8 * j)) & 0xFF;       // the byte at p + 4
    k.h5[j] = hash_of(k.w[j] ^ (b4 * kH5Mix), shift);
  }
}

// The keep rule of one table's buckets h: lane 127, or a bucket that
// differs from the next lane's; and valid.
__device__ __forceinline__ void keep_rule(const int h[4], const bool valid[4],
                                          int L, bool keep[4]) {
  const int next = __shfl_down_sync(kFull, h[0], 1);
  for (int j = 0; j < 3; ++j) keep[j] = valid[j] && h[j] != h[j + 1];
  keep[3] = valid[3] && (L == 31 || h[3] != next);
}

// The unique-bucket rule over the warp's 128 kept keys: ins[j] iff bucket
// h[j] is kept by exactly one lane of the segment. bm is the warp's bitmap
// of 2^hl bits, all clear on entry and on exit.
__device__ __forceinline__ void unique_rule(uint32_t* bm, const int h[4],
                                            const bool keep[4], bool ins[4]) {
  bool first[4];
  for (int j = 0; j < 4; ++j) {
    first[j] = false;
    if (keep[j]) {
      const uint32_t bit = 1u << (h[j] & 31);
      first[j] = !(atomicOr(bm + (h[j] >> 5), bit) & bit);
    }
  }
  __syncwarp();
  for (int j = 0; j < 4; ++j)
    if (keep[j] && !first[j]) atomicAnd(bm + (h[j] >> 5), ~(1u << (h[j] & 31)));
  __syncwarp();
  for (int j = 0; j < 4; ++j)
    ins[j] = first[j] && (bm[h[j] >> 5] >> (h[j] & 31)) & 1;
  __syncwarp();
  for (int j = 0; j < 4; ++j)
    if (ins[j]) atomicAnd(bm + (h[j] >> 5), ~(1u << (h[j] & 31)));
  __syncwarp();
}

// chk13 of the warp's 4 positions a lane: the words at lanes l+4, l+8 and
// l+12 of the segment (circularly) are words j of lanes L+1, L+2, L+3.
__device__ __forceinline__ void seg_chk(const uint32_t w[4], int L,
                                        int chk[4]) {
  for (int j = 0; j < 4; ++j) {
    const uint32_t w4 = __shfl_sync(kFull, w[j], (L + 1) & 31);
    const uint32_t w8 = __shfl_sync(kFull, w[j], (L + 2) & 31);
    const uint32_t w12 = __shfl_sync(kFull, w[j], (L + 3) & 31);
    chk[j] = chk_mix(w[j], w4, w8, w12);
  }
}

// Table access. kShared24 splits an entry (pos + 1 < 2^24) into a 16-bit
// and an 8-bit plane; two lanes never write one entry in one segment, and
// byte and half-word stores to neighbouring entries do not interfere.
template <Place kPlace>
struct Tables {
  int* t;           // kShared32, kGlobal32
  uint16_t* lo;     // kShared24
  uint8_t* hi;
  int tsize;
  __device__ __forceinline__ int get(int k, int h) const {
    const int e = k * tsize + h;
    if (kPlace == kShared24) return lo[e] | hi[e] << 16;
    return t[e];
  }
  __device__ __forceinline__ void set(int k, int h, int v) const {
    const int e = k * tsize + h;
    if (kPlace == kShared24) {
      lo[e] = (uint16_t)v;
      hi[e] = (uint8_t)(v >> 16);
    } else {
      t[e] = v;
    }
  }
  __device__ __forceinline__ void zero(int ntab) const {
    if (kPlace == kShared24) {
      uint32_t* z = reinterpret_cast<uint32_t*>(lo);   // both planes
      for (int k = threadIdx.x; k < ntab * tsize * 3 / 4; k += kThreads)
        z[k] = 0;
    } else {
      for (int k = threadIdx.x; k < ntab * tsize; k += kThreads) t[k] = 0;
    }
  }
};

// Grid: one CTA per block. kProfile: per block, int64 kProf fields into
// prof: the block's cycles; the table loop's busy cycles; a worker warp's
// cycles in key work and in verify work (means over the worker warps); the
// table loop's busy ns on the global timer; the positions that walked the
// probe ladder (emit_ok, no verified h4 candidate); the block's ns on the
// global timer.
template <Place kPlace, bool kProfile>
__global__ void __launch_bounds__(kThreads, 1)
match_find_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ lens, Cfg c, Layout lay,
                  uint16_t* __restrict__ maps, int32_t* gtab,
                  long long* __restrict__ prof) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long acc[kProf];
  const long long t_start = kProfile ? clock64() : 0;
  const long long ns_start = kProfile ? global_ns() : 0;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t* row32 =
      reinterpret_cast<const uint32_t*>(data + (size_t)b * c.stride);
  const int len = lens[b];
  const int tsize = 1 << c.hl;
  const int ntab = lay.ntab;
  const int S = lay.S;
  const int ring = S * kSeg;
  const Tables<kPlace> T{
      kPlace == kGlobal32 ? gtab + (size_t)b * ntab * tsize
                          : reinterpret_cast<int*>(smem),
      reinterpret_cast<uint16_t*>(smem),
      smem + ((size_t)ntab * 2 << c.hl), tsize};
  uint32_t* look = reinterpret_cast<uint32_t*>(smem + lay.look);
  uint32_t* insw = reinterpret_cast<uint32_t*>(smem + lay.ins);
  uint32_t* rawf = reinterpret_cast<uint32_t*>(smem + lay.rawf);
  uint16_t* rawd = reinterpret_cast<uint16_t*>(smem + lay.rawd);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + lay.bits);
  uint8_t* win = smem + lay.win;

  T.zero(ntab);
  for (int k = threadIdx.x; k < (S << (c.hl - 5)); k += kThreads) bits[k] = 0;
  if (kProfile && threadIdx.x < kProf) acc[threadIdx.x] = 0;
  // the row window of chunk j (bytes [j * ring - back, ...)), copied by the
  // worker threads into buffer j % kWindows
  auto fill_window = [&](int j) {
    const int s0 = j * ring - lay.back;
    uint8_t* wb = win + (j % kWindows) * lay.wlen;
    const uint8_t* row = reinterpret_cast<const uint8_t*>(row32);
    for (int t = threadIdx.x - kTableWarps * 32; t < lay.wlen / 8;
         t += kWorkWarps * 32) {
      const int y = s0 + 8 * t;
      const bool ok = y >= 0 && y + 8 <= c.stride;
      copy8_async(wb + 8 * t, ok ? row + y : row, ok);
    }
  };
  if (warp >= kTableWarps) {
    fill_window(0);
    if (S * kSeg < c.n) fill_window(1);
    copy_wait();
  }
  __syncthreads();

  const int nseg = c.n / kSeg;
  const int nchunk = (nseg + S - 1) / S;
  const int shift = 32 - c.hl;
  const int FD = c.far_dist;
  const int far_seg = FD / kSeg;
  const int tab_far = ntab - 1;
  uint16_t* out = maps + (size_t)b * c.nmaps * c.n;
  long long busy = 0, busy_ns = 0, key_busy = 0, probed = 0;

  for (int k = 0; k < nchunk + 2; ++k) {
    if (warp < kTableWarps) {
      // ---- the serial loop over chunk k - 1: table work only
      const int kk = k - 1;
      if (kk >= 0 && kk < nchunk) {
        const long long t0 = kProfile ? clock64() : 0;
        const long long n0 = kProfile ? global_ns() : 0;
        const int l = threadIdx.x;
        const int buf = kk & 1;
        const int segs = min(S, nseg - kk * S);
        const uint32_t* lk = look + buf * ring;
        const uint32_t* ik = insw + buf * ring;
        uint16_t* rd = rawd + (size_t)buf * (1 + c.k5) * ring;
        uint32_t* rf = rawf + buf * ring;
        uint32_t lk_n = lk[l], ik_n = ik[l];
        for (int s = 0; s < segs; ++s) {
          const int i = kk * S + s;
          const int x = s * kSeg + l;
          const int p = i * kSeg + l;
          const uint32_t lk_x = lk_n, ik_x = ik_n;
          const int h = lk_x & 0xFFFF, h5 = lk_x >> 16;
          // every table's entry loaded before any is used
          int v[6];
          v[0] = T.get(0, h);
          if (c.k5) {
#pragma unroll
            for (int t = 1; t < 5; ++t)
              if (t <= c.k5) v[t] = T.get(t, h5);
          }
          if (c.far) v[5] = T.get(tab_far, h);
          rd[x] = dist16(p, v[0]);
          if (c.k5) {
#pragma unroll
            for (int t = 1; t < 5; ++t)
              if (t <= c.k5) rd[t * ring + x] = dist16(p, v[t]);
          }
          if (c.far) rf[x] = (uint32_t)v[5];
          if (s + 1 < segs) {
            lk_n = lk[x + kSeg];
            ik_n = ik[x + kSeg];
          }
          table_barrier();              // every lookup of segment i done
          if (ik_x & 1) T.set(0, h, p + 1);
          if (ik_x & 2) T.set(1 + (i & (c.k5 - 1)), h5, p + 1);
          if (ik_x & 4)
            T.set(tab_far, ik_x >> 16,
                  ((p - FD + 1) << 13) | ((ik_x >> 3) & 8191));
          if (kPlace == kGlobal32) __threadfence_block();
          table_barrier();              // inserts seen by segment i + 1
        }
        if (kProfile) {
          busy += clock64() - t0;
          busy_ns += global_ns() - n0;
        }
      }
    } else {
      const int w = warp - kTableWarps;
      // ---- the window of chunk k + 2, in flight for a stage and ready by
      // the stage after
      if (k + 2 < nchunk) fill_window(k + 2);
      copy_commit();                    // one group a stage, empty or not
      // ---- keys of segment w of chunk k
      if (k < nchunk && w < min(S, nseg - k * S)) {
        const long long t0 = kProfile ? clock64() : 0;
        const int i = k * S + w;
        uint32_t* bm = bits + (w << (c.hl - 5));
        SegKeys sk;
        seg_words(reinterpret_cast<const uint32_t*>(
                      win + (k % kWindows) * lay.wlen),
                  k * ring - lay.back, i, lane, shift, sk);
        bool valid[4], keep[4], ins4[4], ins5[4] = {}, insF[4] = {};
        for (int j = 0; j < 4; ++j) valid[j] = sk.p[j] < len;
        keep_rule(sk.h, valid, lane, keep);
        unique_rule(bm, sk.h, keep, ins4);
        if (c.k5) {
          keep_rule(sk.h5, valid, lane, keep);
          unique_rule(bm, sk.h5, keep, ins5);
        }
        int hq[4] = {}, chkq[4] = {};
        if (c.far && i >= far_seg) {
          // the far insert: the h4 keys of the segment far_dist back
          SegKeys fk;
          seg_words(row32, 0, i - far_seg, lane, shift, fk);
          for (int j = 0; j < 4; ++j) valid[j] = fk.p[j] < len;
          keep_rule(fk.h, valid, lane, keep);
          unique_rule(bm, fk.h, keep, insF);
          seg_chk(fk.w, lane, chkq);
          for (int j = 0; j < 4; ++j) hq[j] = fk.h[j];
        }
        uint4 lv, iv;
        uint32_t* l4 = &lv.x;
        uint32_t* i4 = &iv.x;
        for (int j = 0; j < 4; ++j) {
          l4[j] = (uint32_t)sk.h[j] | (uint32_t)sk.h5[j] << 16;
          i4[j] = (uint32_t)ins4[j] | (uint32_t)ins5[j] << 1 |
                  (uint32_t)insF[j] << 2 | (uint32_t)chkq[j] << 3 |
                  (uint32_t)hq[j] << 16;
        }
        const int x = w * kSeg + 4 * lane;
        *reinterpret_cast<uint4*>(look + (k & 1) * ring + x) = lv;
        *reinterpret_cast<uint4*>(insw + (k & 1) * ring + x) = iv;
        if (kProfile) key_busy += clock64() - t0;
      }
      // ---- verify chunk k - 2 and store its maps
      const int kk = k - 2;
      if (kk >= 0) {
        const long long t0 = kProfile ? clock64() : 0;
        const int buf = kk & 1;
        const int segs = min(S, nseg - kk * S);
        const uint16_t* rd = rawd + (size_t)buf * (1 + c.k5) * ring;
        const uint32_t* rf = rawf + buf * ring;
        const uint32_t* w32 =
            reinterpret_cast<const uint32_t*>(win + (kk % kWindows) *
                                                        lay.wlen);
        const int s0 = kk * ring - lay.back;    // w32[0] is byte s0
        // the word at y, from the window (s0 <= y < (kk + 1) * ring)
        auto wword = [&](int y) {
          const int o = (y - s0) >> 2;
          return __funnelshift_r(w32[o], w32[o + 1], 8 * (y & 3));
        };
        const bool len_ok = len >= kMinLength;
        // groups of 32 positions, the last worker warps first (the first
        // ones computed keys this stage)
        for (int g = kWorkWarps - 1 - w; g < 4 * segs; g += kWorkWarps) {
          const int x = g * 32 + lane;
          const int p = kk * ring + x;
          const uint16_t d4 = rd[x];
          int m = 0;
          if (!(len_ok && p < len - kMfLimit)) {
            // emit_ok fails: every map 0 but the delta map
            for (; m < c.nmaps - (c.chain ? 1 : 0); ++m)
              out[(size_t)m * c.n + p] = 0;
            if (c.chain) out[(size_t)m * c.n + p] = d4;
            continue;
          }
          const uint32_t wp = wword(p);
          // the candidates (h4, then the k5 slots): their words loaded
          // together, from global memory (up to 65535 bytes back)
          int cd[5];
          uint32_t cw[5];
#pragma unroll
          for (int t = 0; t < 5; ++t) {
            cd[t] = t == 0 ? d4 : t <= c.k5 ? rd[t * ring + x] : 0;
            cw[t] = cd[t] > 0 ? word_at(row32, p - cd[t]) : ~wp;
          }
          auto ok = [&](int t) {
            return cd[t] >= c.min_offset && cd[t] <= c.maxoff &&
                   cw[t] == wp;
          };
          int best = 0;
          if (c.k5 == 1 && ok(1)) {        // a verified h5 candidate wins
            best = cd[1];
          } else if (ok(0)) {
            best = d4;
          } else {
            if (kProfile) ++probed;
            // the probe ladder, from the window: every probe, unrolled (a
            // loop over the parameter array indexed at run time, which
            // exits at the first hit, took 4.6 times as long at -11)
            bool found = false;
#pragma unroll
            for (int t = 0; t < kMaxProbes; ++t) {
              const int d = c.probes[t];
              const uint32_t wq = wword(p - d);   // d <= back: in the window
              if (t < c.nprobes && d <= p && wq == wp && !found) {
                best = d;
                found = true;
              }
            }
          }
          out[(size_t)(m++) * c.n + p] = (uint16_t)best;
          if (c.k5 >= 2) {
#pragma unroll
            for (int t = 1; t < 5; ++t)
              if (t <= c.k5)
                out[(size_t)(m++) * c.n + p] = (uint16_t)(ok(t) ? cd[t] : 0);
          }
          if (c.far) {
            const int vF = (int)rf[x];
            const int offF = p - ((vF >> 13) - 1);
            int raw = 0;
            if (vF > 0 && offF >= FD && offF <= 2 * FD - 2) {
              const int base = p & ~(kSeg - 1), l = p & (kSeg - 1);
              const int chk = chk_mix(wp, wword(base + ((l + 4) & 127)),
                                      wword(base + ((l + 8) & 127)),
                                      wword(base + ((l + 12) & 127)));
              if ((vF & 8191) == chk) raw = offF - (FD - 1);
            }
            out[(size_t)(m++) * c.n + p] = (uint16_t)raw;
          }
          if (c.chain) out[(size_t)m * c.n + p] = d4;
        }
        if (kProfile) busy += clock64() - t0;
      }
      // chunk k + 2's window (this stage's group) may stay in flight:
      // wait for chunk k + 1's
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    __syncthreads();
  }
  if (kProfile) {
    if (warp >= kTableWarps && lane == 0) {
      atomicAdd(&acc[2], (unsigned long long)key_busy);
      atomicAdd(&acc[3], (unsigned long long)busy);
    }
    if (warp >= kTableWarps) atomicAdd(&acc[5], (unsigned long long)probed);
    __syncthreads();
    if (threadIdx.x == 0) {
      long long* pr = prof + (size_t)b * kProf;
      pr[0] = clock64() - t_start;
      pr[1] = busy;
      pr[2] = (long long)acc[2] / kWorkWarps;
      pr[3] = (long long)acc[3] / kWorkWarps;
      pr[4] = busy_ns;
      pr[5] = (long long)acc[5];
      pr[6] = global_ns() - ns_start;
    }
  }
}

Cfg read_cfg(const int32_t* v) {
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
  return c;
}

// Where the tables go and how many segments a stage takes: the first of
// kShared32, kShared24 (no far table) whose tables fit beside the smallest
// rings, else kGlobal32; the largest S that fits.
Layout plan(const Cfg& c) {
  Place place = kGlobal32;
  if (layout(c, 1, kShared32).total <= (size_t)kSmemLimit)
    place = kShared32;
  else if (!c.far && layout(c, 1, kShared24).total <= (size_t)kSmemLimit)
    place = kShared24;
  int S = kMaxChunk;
  while (S > 1 && layout(c, S, place).total > (size_t)kSmemLimit) S /= 2;
  return layout(c, S, place);
}

}  // namespace

// Bytes of global table scratch a block needs (0: the tables are in shared
// memory), for params in Cfg's layout.
extern "C" long long match_find_table_bytes(const int32_t* params) {
  const Cfg c = read_cfg(params);
  const Layout L = plan(c);
  return L.place == kGlobal32 ? (long long)L.ntab * 4 << c.hl : 0;
}

// data: (B, stride) uint8 rows, 8-byte aligned, stride = n + 8; lens: (B,)
// int32; params: host int32 array in Cfg's layout (n a multiple of 128, hl
// 8..16, k5 in {0, 1, 2, 4}); maps: (B, nmaps, n) uint16; tables: B x
// match_find_table_bytes(params) bytes, or null when that is 0; prof: null,
// or (B, 7) int64 for the profiling instance. Returns the launch's
// cudaError_t.
extern "C" int match_find_launch(const void* data, const void* lens, int B,
                                 const int32_t* params, void* maps,
                                 void* tables, void* prof, void* stream) {
  const Cfg c = read_cfg(params);
  const Layout L = plan(c);
  const auto kernel =
      L.place == kShared32
          ? (prof ? match_find_kernel<kShared32, true>
                  : match_find_kernel<kShared32, false>)
      : L.place == kShared24
          ? (prof ? match_find_kernel<kShared24, true>
                  : match_find_kernel<kShared24, false>)
          : (prof ? match_find_kernel<kGlobal32, true>
                  : match_find_kernel<kGlobal32, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, L.total, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, c, L, (uint16_t*)maps,
      (int32_t*)tables, (long long*)prof);
  return (int)cudaGetLastError();
}
