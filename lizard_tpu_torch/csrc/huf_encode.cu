// huf_pack: Huff0 (four streams, 1X) bitstream packing of a batch of
// streams, on an H100 (sm_90a).
//
// Replaces the Pallas TPU kernel lizard_tpu/ops/enc_huf.py::_henc_kernel
// (l.41, launched by henc_call l.218). Its contract, not its tiling: per
// segment, each symbol's (code, nbits) from its stream's table, the bit
// offsets by a prefix sum, the codes ORed into 32-bit little-endian words,
// the words stored densely. The TPU kernel packed 8 streams on the sublanes
// of (8, 128) tiles with roll-based scans and the host reordered the
// symbols; here a thread block packs one segment, its warps on contiguous
// pieces of it at once, and reads the symbols backwards in place.
//
// Bit semantics are those of lizard_tpu/ref/huf_encode.py::_huf_encode_1x
// and BitWriter (bitstream.h:181-248): the symbols go from the segment's
// last byte down to its first (the reference's order: the tail bytes n2+2,
// n2+1, n2, then n2-1 .. 0, which is n-1 .. 0), each code LSB first after
// the previous one, then one end-mark bit.
//
// What bounds it on this card. The bytes: each symbol read once, the
// words that hold the codes written once, ~30 MB for a 32 MB batch at -35,
// 9.5 us over 3.35 TB/s. A code's bit offset is the sum of the nbits before
// it, a prefix sum, so no segment needs a serial walk; the work, ~15
// instructions a symbol, is ~8 us of the card's issue rate. Measured on an
// H100 (PERF.md, B8), ~52
// us of device time a call at -35, the words' zeroing ~8 of it: the rest
// is latency the blocks do not hide (their loads, scans and shared-memory
// ORs issue at ~1/3 of the rate), and the longest segments, ~24,000
// symbols, set the end. Tensor
// cores have no role: there is no matrix product, only table lookups,
// shifts, ORs and scans.
//
// Design: two kernels a call. The prep kernel zeroes the words (a word
// that no row in bounds covers stays 0, as in the plain version; the pack
// kernel writes a segment's words only up to its end mark) and, in its
// block 0, orders the rows longest first by a counting sort on their
// length classes, so the long literal segments do not start last. The
// pack kernel: one 128-thread block (4 warps, 8 blocks an SM) per row,
// block b on row order[b], in rounds (one for a segment of up to 17,861
// symbols, whose reserved words fit the block's word buffer in shared
// memory; 6,016 symbols a round beyond). The block copies its stream's
// table (nbits << 16 | code, codes masked to nbits, entries without a code
// marked) into shared memory. In a round each warp takes a contiguous
// piece of the round's emission indices in steps of 512, 16 a lane (16
// consecutive source bytes read backwards, brought in by two aligned
// 16-byte loads and a funnel shift; the next step's loads in flight).
// Small blocks, 8 an SM: a long segment's rounds overlap other segments'
// work (measured faster than 8 warps a segment). Pass 1: each warp counts
// its piece's bits (table lookups, one warp reduction), alone. One
// barrier: the warp totals give each warp its starting bit and the round's
// total, and tell whether a code is missing or the words overflow, before
// anything is written. Pass 2: each warp walks its piece again, alone:
// per step a warp scan by shuffles gives each lane its bit offset; a lane
// packs its codes into a 32-bit word (two codes at a time where the table
// has no code over 16 bits) and ORs each finished word into the segment's
// words in shared memory. After the last round, one barrier, and the words
// up to the end mark go out by coalesced 16-byte stores, plain stores for
// the unaligned head and tail words. So the warps wait for each other
// twice a round, not at every step.
//
// The kernel reads no byte outside [src_off, src_off + len) but by an
// aligned 16-byte load that lies inside data, and writes only the segment's
// words [out_word_off, out_word_off + segment_words(len)): it checks every
// row against the sizes of the tensors first (the wrapper does not read the
// rows, which would wait for the device), and a row outside them gets
// kErrBounds and writes nothing. A symbol whose entry has nbits 0 or above
// 32 gives kErrNoCode (found in any round; it wins); bits that with the end
// mark exceed the segment's words give kErrOverflow (only codes longer than
// 11 bits can). Either leaves the segment's words zero and sets its bit
// count to 0, as the plain version does.
//
// huf_pack_kernel<true> is the profiling instance (enc_huf.huf_pack_profile):
// thread 0's clock64 per phase, per block: {cycles, setup, load, lookup and
// count, scan across the block, scatter, store, rounds, ns}.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSegments = 4;            // per stream
constexpr int kFields = 4;              // segment row
constexpr int kTableEntries = 256;
constexpr int kMaxBits = 11;            // the words reserved per symbol
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;         // 64 registers, 8 x 25 KB of shared
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;                // emission indices a lane, a step
constexpr int kStep = 32 * kRun;        // PACK_STEP in ops/enc_huf.py
// The segment's words in shared memory: segment_words(17861) = 6141 words,
// + 3 for the 16-byte alignment of the first word. A longer segment goes
// in rounds of kRoundSyms symbols, whose words (at most kRoundSyms + 1 at
// 32 bits a code) fit once the finished ones are flushed.
constexpr int kBufWords = 6144;
constexpr int kRoundSyms = 6016;        // PACK_ROUND, a multiple of 16
constexpr int kProfFields = 9;
constexpr int kPrepThreads = 256;
constexpr int kPrepBlocks = 1024;       // at most, for the zeroing
constexpr int kClasses = 18;            // length classes of 2,048 symbols
constexpr uint32_t kBad = 0x80000000u;  // a table entry without a code

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

// clock64 read after `v` is ready: a phase's end waits for its last value.
__device__ __forceinline__ long long clock_after(uint32_t v) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(v) : "memory");
  return t;
}

// The 16 bytes at data[c, c + 16) (data + c 16-byte aligned): one vector
// load where the chunk lies inside data, else the bytes inside the segment
// [lo, hi) one by one; 0 for a chunk that misses the segment.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ data,
                                            int64_t n_data, int64_t c,
                                            int64_t lo, int64_t hi) {
  if (c + 16 <= lo || c >= hi) return make_uint4(0, 0, 0, 0);
  if (c >= 0 && c + 16 <= n_data)
    return __ldg(reinterpret_cast<const uint4*>(data + c));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int64_t q = c + b;
    if (q >= lo && q < hi)
      w[b >> 2] |= static_cast<uint32_t>(data[q]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The two 16-byte chunks that hold a lane's 16 source bytes [lo, lo + 16),
// data + lo - m 16-byte aligned (m is the same for every lane and step of
// a block).
struct Run {
  uint4 a, b;
};

__device__ __forceinline__ Run load_run(const uint8_t* __restrict__ data,
                                        int64_t n_data, int64_t lo, int m,
                                        int64_t seg_lo, int64_t seg_hi) {
  return {load_chunk(data, n_data, lo - m, seg_lo, seg_hi),
          load_chunk(data, n_data, lo - m + 16, seg_lo, seg_hi)};
}

// w[i + q] for a compile-time i and a run-time q in 0..3, without indexing
// registers at run time.
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[8], int i,
                                         int q) {
  uint32_t v = w[i];
  v = q == 1 ? w[i + 1] : v;
  v = q == 2 ? w[i + 2] : v;
  v = q == 3 ? w[i + 3] : v;
  return v;
}

// A lane's 16 source bytes out of its two chunks: byte b of x is source
// byte lo + b.
__device__ __forceinline__ void run_bytes(const Run& run, int q, int r,
                                          uint32_t (&x)[4]) {
  const uint32_t w[8] = {run.a.x, run.a.y, run.a.z, run.a.w,
                         run.b.x, run.b.y, run.b.z, run.b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __funnelshift_r(pick(w, i, q), pick(w, i + 1, q), r);
}

// The table entries of a lane's symbols in emission order (byte 15 - i of
// x), 0 (no bits) past its nvalid symbols; returns their bits, where an
// entry without a code counts 0x8000, more than a lane's codes can.
__device__ __forceinline__ uint32_t lookup_run(const uint32_t* table,
                                               const uint32_t (&x)[4],
                                               int nvalid,
                                               uint32_t (&e)[kRun]) {
  uint32_t sum = 0;
  if (nvalid == kRun) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int b = kRun - 1 - i;
      e[i] = table[(x[b >> 2] >> (8 * (b & 3))) & 0xFFu];
      sum += e[i] >> 16;
    }
  } else {                              // the last run of a segment
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int b = kRun - 1 - i;
      e[i] = i < nvalid ? table[(x[b >> 2] >> (8 * (b & 3))) & 0xFFu] : 0u;
      sum += e[i] >> 16;
    }
  }
  return sum;
}

// buf[sa] |= v, sa a shared-memory address.
__device__ __forceinline__ void red_or(uint32_t sa, uint32_t v) {
  asm volatile("red.shared.or.b32 [%0], %1;" : : "r"(sa), "r"(v) : "memory");
}

// A lane's codes from bit ab of the buffer word at shared address sa, a
// 32-bit word at a time (the bits of a code past the word wait in `up`),
// each finished word and the last part-word ORed into the buffer (the
// first and last may be shared with the neighbouring lanes). `narrow`:
// no code over 16 bits, so two codes make at most one word, ORed in
// unconditionally (0 when none is done). Returns the last part-word.
__device__ __forceinline__ uint32_t scatter_run(const uint32_t (&e)[kRun],
                                                bool narrow, int nvalid,
                                                uint32_t sa, uint32_t ab) {
  uint32_t acc = 0;
  if (narrow) {
#pragma unroll
    for (int i = 0; i < kRun; i += 2) {
      const uint32_t n0 = e[i] >> 16;
      const uint32_t c = (e[i] & 0xFFFFu) | ((e[i + 1] & 0xFFFFu) << n0);
      acc |= c << ab;
      const uint32_t up = __funnelshift_l(c, 0u, ab);
      ab += n0 + (e[i + 1] >> 16);
      const uint32_t done = ab >= 32;
      red_or(sa, done ? acc : 0u);
      sa += 4 * done;
      acc = done ? up : acc;
      ab -= 32 * done;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {    // e[i] = 0 past nvalid: no bits
      const uint32_t c = e[i] & 0xFFFFu;
      acc |= c << ab;
      const uint32_t up = __funnelshift_l(c, 0u, ab);
      ab += e[i] >> 16;
      const uint32_t done = ab >= 32;
      if (done) red_or(sa, acc);
      sa += 4 * done;
      acc = done ? up : acc;
      ab -= 32 * done;
    }
  }
  if (nvalid > 0 && ab > 0) red_or(sa, acc);
  return acc;
}

// dst[0, n) = buf[lead, lead + n), 0 past the buffer, all 0 when `zero`;
// dst lies `lead` words past a 16-byte boundary, so the words between the
// head and the tail go out as 16-byte stores read from aligned buffer words.
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst,
                                            const uint32_t* buf, int lead,
                                            int64_t n, bool zero) {
  const int tid = threadIdx.x;
  const int head = static_cast<int>(n < ((4 - lead) & 3) ? n : (4 - lead) & 3);
  if (tid < head) dst[tid] = zero ? 0u : buf[lead + tid];
  const int64_t body = (n - head) / 4;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int64_t k = tid; k < body; k += kThreads) {
    const int64_t i = lead + head + 4 * k;
    d4[k] = (zero || i >= kBufWords)
                ? make_uint4(0, 0, 0, 0)
                : *reinterpret_cast<const uint4*>(buf + i);
  }
  const int64_t done = head + 4 * body;
  if (tid < n - done) {
    const int64_t i = lead + done + tid;
    dst[done + tid] = (zero || i >= kBufWords) ? 0u : buf[i];
  }
}

// A row's length class: 0 for an empty row (or a negative length), then
// one class per 2,048 symbols, the last for 32,768 and beyond.
__device__ __forceinline__ int len_class(int64_t len) {
  if (len <= 0) return 0;
  const int64_t c = (len >> 11) + 1;
  return c < kClasses - 1 ? static_cast<int>(c) : kClasses - 1;
}

// The words zeroed (a word that no row in bounds covers stays 0, as in the
// plain version), and, by block 0 alongside, the rows put in order[0,
// n_seg) longest first by a counting sort on their length classes: the
// pack kernel's block b packs row order[b], so no long segment is left to
// start last.
__global__ void __launch_bounds__(kPrepThreads)
huf_prep_kernel(const int64_t* __restrict__ segs, int64_t n_seg,
                uint32_t* __restrict__ words, int64_t n_words,
                int32_t* __restrict__ order) {
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * kPrepThreads +
                     threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPrepThreads;
  const int64_t lead =
      ((16 - (reinterpret_cast<uintptr_t>(words) & 15)) & 15) / 4;
  const int64_t head = lead < n_words ? lead : n_words;
  if (gt < head) words[gt] = 0;
  const int64_t body = (n_words - head) / 4;
  uint4* w4 = reinterpret_cast<uint4*>(words + head);
  for (int64_t i = gt; i < body; i += stride) w4[i] = make_uint4(0, 0, 0, 0);
  const int64_t done = head + 4 * body;
  if (gt < n_words - done) words[done + gt] = 0;
  if (blockIdx.x != 0 || n_seg == 0) return;
  __shared__ int start[kClasses];
  for (int c = threadIdx.x; c < kClasses; c += kPrepThreads) start[c] = 0;
  __syncthreads();
  for (int64_t r = threadIdx.x; r < n_seg; r += kPrepThreads)
    atomicAdd(&start[len_class(segs[r * kFields + 1])], 1);
  __syncthreads();
  if (threadIdx.x == 0) {               // the longest class first
    int sum = 0;
    for (int c = kClasses - 1; c >= 0; --c) {
      const int n = start[c];
      start[c] = sum;
      sum += n;
    }
  }
  __syncthreads();
  for (int64_t r = threadIdx.x; r < n_seg; r += kPrepThreads)
    order[atomicAdd(&start[len_class(segs[r * kFields + 1])], 1)] =
        static_cast<int32_t>(r);
}

// segs: (n_streams * 4, 4) int64 rows src_off, len, table_row,
// out_word_off; the four rows of a stream name one table. One block a row,
// block b on row order[b].
template <bool kProf>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
huf_pack_kernel(const uint8_t* __restrict__ data, int64_t n_data,
                const int64_t* __restrict__ segs,
                const uint32_t* __restrict__ tables, int64_t n_tables,
                uint32_t* __restrict__ words, int64_t n_words,
                int64_t* __restrict__ bits, int32_t* __restrict__ status,
                const int32_t* __restrict__ order,
                int64_t* __restrict__ prof) {
  __shared__ __align__(16) uint32_t buf[kBufWords];
  __shared__ uint32_t table[kTableEntries];
  __shared__ uint32_t totals[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const unsigned full = 0xFFFFFFFFu;
  const int64_t seg = order[blockIdx.x];
  long long t_ns = 0, t_start = 0, t = 0;
  // setup, load, count, scan, scatter, store
  long long cyc[6] = {0, 0, 0, 0, 0, 0};
  if (kProf && tid == 0) {
    t_ns = global_ns();
    t_start = t = clock64();
  }
  // thread 0's cycles since the last tick go to phase k, once v is ready
  auto tick = [&](int k, uint32_t v) {
    if (kProf && tid == 0) {
      const long long now = clock_after(v);
      cyc[k] += now - t;
      t = now;
    }
  };

  const int64_t* row = segs + seg * kFields;
  const int64_t t_row = segs[(seg / kSegments) * kSegments * kFields + 2];
  const int64_t src_off = row[0], len = row[1], out_off = row[3];
  if (!(t_row >= 0 && t_row < n_tables && row[2] == t_row && src_off >= 0 &&
        len >= 0 && len <= n_data - src_off && out_off >= 0 &&
        out_off <= n_words && segment_words(len) <= n_words - out_off)) {
    if (tid == 0) {  // the whole block leaves
      status[seg] = kErrBounds;
      bits[seg] = 0;
    }
    return;
  }
  const int64_t hi = src_off + len;
  // emission index k is the source byte hi - 1 - k; lane `lane` of a step
  // at emission index s takes the bytes [hi - s - 16 (lane + 1), + 16)
  const int m = static_cast<int>(
      (static_cast<int64_t>(reinterpret_cast<uintptr_t>(data) & 15) + hi) & 15);
  const int q = m >> 2, r = 8 * (m & 3);
  uint32_t wide = 0;                    // a code of 17-32 bits
  for (int i = tid; i < kTableEntries; i += kThreads) {
    const uint32_t e = tables[t_row * kTableEntries + i];
    const uint32_t nb = e >> 16;
    const uint32_t mask = nb >= 16 ? 0xFFFFu : (1u << nb) - 1;
    table[i] = (nb == 0 || nb > 32) ? kBad : (nb << 16) | (e & mask);
    wide |= nb > 16 && nb <= 32;
  }
  const int64_t cap = segment_words(len);
  const int64_t limit = 32 * cap;       // bits the words hold, end mark included
  uint32_t* out = words + out_off;
  // buffer word lead + (j - win) holds the segment's word j
  const int lead0 = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  int lead = lead0;
  int64_t win = 0;
  {
    const int64_t used = cap + lead < kBufWords ? cap + lead : kBufWords;
    for (int i = tid; i < (used + 3) / 4; i += kThreads)
      reinterpret_cast<uint4*>(buf)[i] = make_uint4(0, 0, 0, 0);
  }
  // codes of at most 16 bits (every Huff0 table): packed two at a time
  const bool narrow = !__syncthreads_or(wide);
  tick(0, 0);

  const uint32_t buf_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  // a segment whose reserved words fit the buffer in one round
  const int64_t round = cap + 3 <= kBufWords ? len : kRoundSyms;
  int64_t pos = 0;                      // the segment's bits so far
  bool no_code = false, overflow = false;
  int rounds = 0;
  for (int64_t r0 = 0; r0 < len; r0 += round) {
    ++rounds;
    const int64_t rlen = len - r0 < round ? len - r0 : round;
    // this warp's steps of the round: [s0, s1), each kStep emission indices
    const int64_t steps = (rlen + kStep - 1) / kStep;
    const int64_t per = (steps + kWarps - 1) / kWarps;
    const int64_t s0 = warp * per < steps ? warp * per : steps;
    const int64_t s1 = s0 + per < steps ? s0 + per : steps;
    auto lane_lo = [&](int64_t s) {     // the first source byte of this lane
      return hi - r0 - s * kStep - static_cast<int64_t>(lane + 1) * kRun;
    };
    auto lane_valid = [&](int64_t s) {  // its symbols in the segment
      const int64_t left = rlen - s * kStep - static_cast<int64_t>(lane) * kRun;
      return static_cast<int>(left < 0 ? 0 : left > kRun ? kRun : left);
    };

    // pass 1: this warp's bits, and whether a code is missing
    uint32_t wsum = 0, bad = 0;
    {
      Run run;
      if (s0 < s1) run = load_run(data, n_data, lane_lo(s0), m, src_off, hi);
      for (int64_t s = s0; s < s1; ++s) {
        uint32_t x[4];
        run_bytes(run, q, r, x);
        tick(1, x[0] ^ x[3]);
        if (s + 1 < s1)
          run = load_run(data, n_data, lane_lo(s + 1), m, src_off, hi);
        uint32_t e[kRun];
        const uint32_t sum = lookup_run(table, x, lane_valid(s), e);
        wsum += sum;
        bad |= sum;
        tick(2, sum);
      }
    }
    wsum = __reduce_add_sync(full, wsum);
    bad = __reduce_or_sync(full, bad & 0xFFFF8000u);
    if (lane == 0) totals[warp] = bad ? kBad : wsum;
    tick(2, wsum);

    // scan across the block: every thread reads the warp totals
    __syncthreads();
    uint32_t before = 0, total = 0, any_bad = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const uint32_t v = totals[k];
      any_bad |= v;
      if (k < warp) before += v;
      total += v;
    }
    __syncthreads();                    // totals free for the next round
    tick(3, total ^ before);
    if (any_bad & kBad) {               // uniform: a symbol without a code
      no_code = true;
      break;
    }
    if (overflow || pos + total + 1 > limit) {  // then only look for no code
      overflow = true;
      continue;
    }
    // a segment longer than the buffer: flush the finished words first
    if (lead + (((pos + total) >> 5) - win) >= kBufWords) {
      const int64_t keep = pos >> 5;
      store_words(out + win, buf, lead, keep - win, false);
      const uint32_t carry = buf[lead + (keep - win)];
      __syncthreads();
      win = keep;
      lead = static_cast<int>((reinterpret_cast<uintptr_t>(out + win) >> 2) & 3);
      for (int i = tid; i < kBufWords; i += kThreads)
        buf[i] = i == lead ? carry : 0u;
      __syncthreads();
      tick(5, carry);
    }

    // pass 2: this warp's codes from bit pos + before, a step at a time
    {
      int64_t wpos = pos + before;
      Run run;
      if (s0 < s1) run = load_run(data, n_data, lane_lo(s0), m, src_off, hi);
      for (int64_t s = s0; s < s1; ++s) {
        uint32_t x[4];
        run_bytes(run, q, r, x);
        tick(1, x[0] ^ x[3]);
        if (s + 1 < s1)
          run = load_run(data, n_data, lane_lo(s + 1), m, src_off, hi);
        const int nvalid = lane_valid(s);
        uint32_t e[kRun];
        const uint32_t sum = lookup_run(table, x, nvalid, e);
        uint32_t incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t u = __shfl_up_sync(full, incl, d);
          if (lane >= d) incl += u;
        }
        const int64_t off = wpos + incl - sum;
        wpos += __shfl_sync(full, incl, 31);
        tick(2, incl);
        const uint32_t sa = buf_base + 4u * static_cast<uint32_t>(
                                           lead + ((off >> 5) - win));
        tick(4, scatter_run(e, narrow, nvalid, sa,
                            static_cast<uint32_t>(off & 31)));
      }
    }
    pos += total;
  }

  const int st = no_code ? kErrNoCode : overflow ? kErrOverflow : kOk;
  if (st == kOk && tid == 0)            // the end mark
    red_or(buf_base + 4u * static_cast<uint32_t>(lead + ((pos >> 5) - win)),
           1u << (pos & 31));
  __syncthreads();
  // the words past the end mark's are the prep kernel's zeros; an error
  // segment zeroes only what a flush stored
  if (st == kOk) store_words(out + win, buf, lead, (pos >> 5) + 1 - win, false);
  else store_words(out, buf, lead0, win, true);
  if (tid == 0) {
    bits[seg] = st == kOk ? pos : 0;
    status[seg] = st;
  }
  tick(5, 0);
  if (kProf && tid == 0) {
    int64_t* p = prof + seg * kProfFields;
    p[0] = t - t_start;
    for (int k = 0; k < 6; ++k) p[1 + k] = cyc[k];
    p[7] = rounds;
    p[8] = global_ns() - t_ns;
  }
}

}  // namespace

// The prep kernel (the words zeroed, the rows ordered), then the pack
// kernel, one block a row; words holds n_words + n_seg int32, the last
// n_seg the rows' order. prof: nullptr for the plain launch, else int64
// (n_seg, 9) for the profiling instance. Launches 2 kernels (1 with no
// rows, none with no rows and no words).
extern "C" int huf_pack_launch(int device, const uint8_t* data,
                               int64_t n_data, const int64_t* segs,
                               int64_t n_seg, const int32_t* tables,
                               int64_t n_tables, int32_t* words,
                               int64_t n_words, int64_t* bits, int32_t* status,
                               int64_t* prof, void* stream) {
  if (n_seg > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg <= 0 && n_words <= 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  int32_t* order = words + n_words;
  const int64_t want = (n_words / 4 + kPrepThreads - 1) / kPrepThreads;
  const unsigned prep = static_cast<unsigned>(
      want < 1 ? 1 : want > kPrepBlocks ? kPrepBlocks : want);
  huf_prep_kernel<<<prep, kPrepThreads, 0, s>>>(segs, n_seg > 0 ? n_seg : 0,
                                                 w, n_words, order);
  err = cudaGetLastError();
  if (err == cudaSuccess && n_seg > 0) {
    const unsigned grid = static_cast<unsigned>(n_seg);
    const uint32_t* tab = reinterpret_cast<const uint32_t*>(tables);
    if (prof)
      huf_pack_kernel<true><<<grid, kThreads, 0, s>>>(
          data, n_data, segs, tab, n_tables, w, n_words, bits, status, order,
          prof);
    else
      huf_pack_kernel<false><<<grid, kThreads, 0, s>>>(
          data, n_data, segs, tab, n_tables, w, n_words, bits, status, order,
          nullptr);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
