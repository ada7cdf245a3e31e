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
// What bounds it on this card: bytes, at the floor. Each block is read once
// (128 KB) and nmaps uint16 maps are written (256 KB each): for the 32 MB
// corpus at level 11, 32 MB in and 64 MB out, ~29 us at 3.35 TB/s. The
// kernel is far above that floor: the 1024 segments of a block are serial
// (each sees the previous one's inserts), and each segment does dependent
// table lookups, byte compares and a 128-wide duplicate count.
//
// Design, a first version: one thread block per input block, 128 threads,
// one per position of a segment, looping over the segments. The tables live
// in dynamic shared memory when they fit (hl 13 with up to six tables,
// 192 KB; hl 15 with one, 128 KB); at hl 16 (256 KB) in a per-block slice of
// a global scratch buffer that the wrapper allocates. Bytes are read
// straight from the packed block in global memory (L1/L2 hold it): no ring,
// no word tiling, no one-hot insert. The unique-bucket rule is a count over
// the segment's 128 keys in shared memory (a broadcast read per key).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kMaxProbes = 16;
constexpr int kMfLimit = 20;         // MFLIMIT
constexpr int kMinLength = 21;       // LIZARD_MIN_LENGTH
constexpr uint32_t kHmul = 2654435761u;
constexpr uint32_t kH5Mix = 0x9E3Bu;
constexpr uint32_t kChk1 = 0x85EBCA6Bu;
constexpr uint32_t kChk2 = 0xC2B2AE3Du;
constexpr uint32_t kChk3 = 668265263u;

// The layout of the int32 parameter array the wrapper passes
// (lizard_tpu_torch/ops/enc_lanes.py::_match_params).
struct Cfg {
  int n, stride, hl, maxoff, min_offset, k5, far, far_dist, chain, nmaps,
      nprobes;
  int probes[kMaxProbes];
};

// The 4 little-endian bytes at p (p + 3 < stride: rows are padded).
__device__ __forceinline__ uint32_t w8_at(const uint8_t* row, int p) {
  return (uint32_t)row[p] | ((uint32_t)row[p + 1] << 8) |
         ((uint32_t)row[p + 2] << 16) | ((uint32_t)row[p + 3] << 24);
}

__device__ __forceinline__ int hash_of(uint32_t w, int shift) {
  return (int)((w * kHmul) >> shift);
}

// chk13 of the position at lane l of segment seg.
__device__ __forceinline__ int chk13(const uint8_t* row, int seg, int l) {
  const int base = seg * kSeg;
  const uint32_t mix = w8_at(row, base + l) ^
                       (w8_at(row, base + ((l + 4) & 127)) * kChk1) ^
                       (w8_at(row, base + ((l + 8) & 127)) * kChk2) ^
                       (w8_at(row, base + ((l + 12) & 127)) * kChk3);
  return (int)(((mix * kHmul) >> 19) & 8191);
}

// Lookup of a verified candidate in table tab at bucket h: the previous
// position, or -1.
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

// Writes the keep-filtered key of lane l into keys (a bucket, or -1), from
// the raw keys of the segment in raw.
__device__ __forceinline__ void keep_key(int* keys, const int* raw, int l,
                                         bool valid) {
  const int h = raw[l];
  const bool keep = valid && (l == kSeg - 1 || h != raw[l + 1]);
  keys[l] = keep ? h : -1;
}

// Inserts val at bucket keys[l] if no other lane of the segment kept it.
__device__ __forceinline__ void insert_unique(int* tab, const int* keys,
                                              int l, int val) {
  const int h = keys[l];
  if (h < 0) return;
  int count = 0;
  for (int k = 0; k < kSeg; ++k) count += keys[k] == h;
  if (count == 1) tab[h] = val;
}

__global__ void __launch_bounds__(kSeg)
match_find_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ lens, Cfg c,
                  uint16_t* __restrict__ maps, int32_t* gtab) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const uint8_t* row = data + (size_t)b * c.stride;
  const int len = lens[b];
  const int tsize = 1 << c.hl;
  const int ntab = 1 + c.k5 + (c.far ? 1 : 0);
  int* tab = gtab ? gtab + (size_t)b * ntab * tsize : smem;
  int* keys = gtab ? smem : smem + ntab * tsize;   // 6 x 128 ints
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
  for (int i = 0; i < c.n / kSeg; ++i) {
    const int p = i * kSeg + l;
    const uint32_t w = w8_at(row, p);
    const int h = hash_of(w, shift);
    int h5 = 0;
    if (c.k5) h5 = hash_of(w ^ ((uint32_t)row[p + 4] * kH5Mix), shift);

    // ---- lookups (the tables as segment i-1's inserts left them)
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

    // ---- inserts: the raw keys, then the kept keys, then the tables
    const bool do_far = c.far && i >= far_seg;
    const int q = p - FD;                 // the far insert's position
    raw4[l] = h;
    if (c.k5) raw5[l] = h5;
    if (do_far) rawf[l] = hash_of(w8_at(row, q), shift);
    __syncthreads();                      // lookups done, raw keys written
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
    __syncthreads();                      // inserts done before next lookup
  }
}

}  // namespace

// data: (B, stride) uint8 rows; lens: (B,) int32; params: host int32 array
// in Cfg's layout; maps: (B, nmaps, n) uint16; scratch: B * ntab << hl int32
// for tables in global memory, or null for tables in shared memory.
// Returns the launch's cudaError_t.
extern "C" int match_find_launch(const void* data, const void* lens, int B,
                                 const int32_t* params, void* maps,
                                 void* scratch, void* stream) {
  Cfg c;
  const int32_t* v = params;
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
      match_find_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_find_kernel<<<B, kSeg, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, c, (uint16_t*)maps,
      (int32_t*)scratch);
  return (int)cudaGetLastError();
}
