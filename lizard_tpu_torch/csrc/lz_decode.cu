// lz_decode: LZ decode of post-entropy Lizard streams, both codeword
// families (fastLZ4 and LIZv1), on an H100 (sm_90a).
//
// Replaces lizard_tpu/ops/lane_decode.py::_lane_kernel (the Pallas TPU
// kernel launched by _lane_call), and the block decoders
// lizard_tpu/ops/pallas_decode.py::_lz4_block_kernel (l.171) and
// _liz_block_kernel (l.304), whose host side is
// lizard_tpu_torch/ops/pallas_decode.py. Their contract, not their tiling:
// the post-entropy streams (flags, literals, off16, off24) of a batch of
// inner blocks, grouped into chains (the consecutive inner blocks of one
// compressed stream, which share one LZ77 window), decode to each chain's
// bytes, each block's decoded length and a per-chain status.
//
// What bounds it on this card: the token parse is a dependent serial chain
// (each token's stream positions depend on the previous token's lengths),
// so one chain runs at the latency of its loads and branches, not at the
// card's bandwidth. The floor is the HBM traffic: the compressed streams
// read once and the decoded bytes written once, over 3.35 TB/s.
//
// What the design does about it: one warp per chain, several chains per
// thread block, so every SM holds many independent serial chains. All 32
// lanes parse each token redundantly (the same bytes, broadcast loads, no
// divergence); literal and match copies are lane-parallel, 32 bytes a
// step. Match sources are read straight from the chain's own output in
// global memory, which removes everything the TPU kernel needed for want of
// a general gather: the VMEM ring, the far window, bands, the DMA-refilled
// stream windows and the host overflow path. An overlapping match
// (offset < length) copies out[d+k] = out[d-off + (k mod off)]: every source
// byte lies in the prefix written before the match began. __syncwarp()
// after each copy orders the lanes' global stores before the next copy's
// loads, which may read bytes other lanes just wrote.
//
// Semantics and corruption checks are those of the bit-exact oracle
// lizard_tpu/ref/block_decode.py (stricter only where the oracle would read
// past a stream's end). The kernel never reads or writes outside its
// tensors: the host validated the block table, every stream read is
// checked, and each inner block's output is capped at LIZARD_BLOCK_SIZE
// inside its chain's region. On corruption the chain stops and its status
// is set; the Python caller raises CorruptError.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kBlockSize = 1 << 17;   // LIZARD_BLOCK_SIZE
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// status codes, shared with lizard_tpu_torch/ops/lane_decode.py
constexpr int kOk = 0;
constexpr int kErrLenExt = -1;
constexpr int kErrLiterals = -2;
constexpr int kErrOffset = -3;
constexpr int kErrOff16 = -4;
constexpr int kErrOff24 = -5;
constexpr int kErrRep0 = -6;
constexpr int kErrCapacity = -7;

struct Block {
  const uint8_t* flags;
  int64_t flen;
  const uint8_t* lit;
  int64_t iend;
  const uint8_t* o16;
  int64_t n16;
  const uint8_t* o24;
  int64_t n24;
};

// Length extension at lit[lp] (doc/lizard_Block_format.md:91-96): byte <254
// is the value; 254 -> LE16 follows; 255 -> LE24 follows. Every byte read
// lies before iend, else false.
__device__ __forceinline__ bool read_ext(const uint8_t* lit, int64_t& lp,
                                         int64_t iend, int64_t& value) {
  if (lp > iend - 1) return false;
  const unsigned first = lit[lp];
  const int need = first < 254 ? 1 : (first == 254 ? 3 : 4);
  if (lp + need > iend) return false;
  if (first == 254) {
    value = lit[lp + 1] | (lit[lp + 2] << 8);
  } else if (first == 255) {
    value = lit[lp + 1] | (lit[lp + 2] << 8) | (lit[lp + 3] << 16);
  } else {
    value = first;
  }
  lp += need;
  return true;
}

__device__ __forceinline__ void copy_literals(uint8_t* dst, const uint8_t* src,
                                              int64_t n, int lane) {
  for (int64_t k = lane; k < n; k += 32) dst[k] = src[k];
  __syncwarp(kFull);
}

// out[op + k] = out[op - off + (k mod off)] for k < n.
__device__ __forceinline__ void copy_match(uint8_t* out, int64_t op,
                                           int64_t off, int64_t n, int lane) {
  const uint8_t* src = out + op - off;
  uint8_t* dst = out + op;
  if (off >= n) {
    for (int64_t k = lane; k < n; k += 32) dst[k] = src[k];
  } else {
    const unsigned uoff = static_cast<unsigned>(off);
    for (unsigned k = lane; k < static_cast<unsigned>(n); k += 32)
      dst[k] = src[k % uoff];
  }
  __syncwarp(kFull);
}

// fastLZ4 token loop (lizard_decompress_lz4.h; oracle _decode_block_lz4).
// The LE16 offset and both length extensions come from the literals stream.
__device__ int decode_lz4(const Block& b, uint8_t* out, int64_t& op,
                          int64_t bend, int lane) {
  const int64_t iend = b.iend;
  int64_t lp = 0;
  for (int64_t fp = 0; fp < b.flen; ++fp) {
    const unsigned token = b.flags[fp];
    int64_t length = token & 15;
    if (length == 15) {
      int64_t ext;
      if (lp > iend - 5 || !read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
      length += ext;
    }
    if (lp + length > iend - (2 + 16)) return kErrLiterals;
    if (op + length > bend) return kErrCapacity;
    copy_literals(out + op, b.lit + lp, length, lane);
    op += length;
    lp += length;
    const int64_t off = b.lit[lp] | (b.lit[lp + 1] << 8);
    lp += 2;
    if (off == 0 || op - off < 0) return kErrOffset;
    length = token >> 4;
    if (length == 15) {
      int64_t ext;
      if (lp > iend - 5 || !read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
      length += ext;
    }
    length += 4;  // MINMATCH
    if (op + length > bend) return kErrCapacity;
    copy_match(out, op, off, length, lane);
    op += length;
  }
  const int64_t n = iend - lp;  // last literals
  if (op + n > bend) return kErrCapacity;
  copy_literals(out + op, b.lit + lp, n, lane);
  op += n;
  return kOk;
}

// LIZv1 token loop (lizard_decompress_liz.h; oracle _decode_block_liz).
// last_off resets at every inner block; the window does not.
__device__ int decode_liz(const Block& b, uint8_t* out, int64_t& op,
                          int64_t bend, int lane) {
  const int64_t iend = b.iend;
  int64_t lp = 0, p16 = 0, p24 = 0, last_off = 0;
  for (int64_t fp = 0; fp < b.flen; ++fp) {
    const unsigned token = b.flags[fp];
    int64_t length;
    if (token >= 32) {
      // [F_MMMM_LLL]: up to 7 literals, then a new off16 or the rep offset
      length = token & 7;
      if (length == 7) {
        int64_t ext;
        if (!read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
        length += ext;
      }
      if (lp > iend - 16 || lp + length > iend) return kErrLiterals;
      if (op + length > bend) return kErrCapacity;
      copy_literals(out + op, b.lit + lp, length, lane);
      op += length;
      lp += length;
      if ((token >> 7) == 0) {
        if (p16 + 2 > b.n16) return kErrOff16;
        last_off = b.o16[p16] | (b.o16[p16 + 1] << 8);
        p16 += 2;
      }
      length = (token >> 3) & 15;
      if (length == 15) {
        int64_t ext;
        if (!read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
        length += ext;
      }
    } else {
      if (token < 31) {
        length = token + 16;  // MM_LONGOFF
      } else {
        // token 31: the length extension comes before the off24
        int64_t ext;
        if (!read_ext(b.lit, lp, iend, ext)) return kErrLenExt;
        length = ext + 31 + 16;
      }
      if (p24 > b.n24 - 3) return kErrOff24;
      last_off = b.o24[p24] | (b.o24[p24 + 1] << 8) | (b.o24[p24 + 2] << 16);
      p24 += 3;
    }
    if (last_off == 0) {
      if (length != 0) return kErrRep0;  // only an empty rep match is legal
    } else if (op - last_off < 0) {
      return kErrOffset;
    }
    if (op + length > bend) return kErrCapacity;
    if (length) copy_match(out, op, last_off, length, lane);
    op += length;
  }
  const int64_t n = iend - lp;  // last literals
  if (op + n > bend) return kErrCapacity;
  copy_literals(out + op, b.lit + lp, n, lane);
  op += n;
  return kOk;
}

// blocks: (n_blocks, 8) int64 rows flags_off, flags_len, lit_off, lit_len,
// off16_off, off16_len, off24_off, off24_len. chains: (n_chains, 3) int64
// rows first block, block count, output base.
template <int kFamily>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lz_decode_kernel(const uint8_t* __restrict__ flags,
                 const uint8_t* __restrict__ literals,
                 const uint8_t* __restrict__ off16,
                 const uint8_t* __restrict__ off24,
                 const int64_t* __restrict__ blocks,
                 const int64_t* __restrict__ chains, int64_t n_chains,
                 uint8_t* out_all, int32_t* __restrict__ block_len,
                 int32_t* __restrict__ status) {
  const int64_t chain =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (chain >= n_chains) return;  // whole warp
  const int64_t first = chains[chain * 3 + 0];
  const int64_t count = chains[chain * 3 + 1];
  uint8_t* out = out_all + chains[chain * 3 + 2];
  int64_t op = 0;  // chain-relative output position
  int st = kOk;
  int64_t i = 0;
  for (; i < count; ++i) {
    const int64_t* m = blocks + (first + i) * 8;
    const Block b{flags + m[0], m[1], literals + m[2], m[3],
                  off16 + m[4], m[5], off24 + m[6], m[7]};
    const int64_t start = op;
    st = kFamily == 0 ? decode_lz4(b, out, op, start + kBlockSize, lane)
                      : decode_liz(b, out, op, start + kBlockSize, lane);
    if (st != kOk) break;
    if (lane == 0) block_len[first + i] = static_cast<int32_t>(op - start);
  }
  if (lane == 0) {
    status[chain] = st;
    for (; i < count; ++i) block_len[first + i] = -1;
  }
}

}  // namespace

extern "C" int lz_decode_launch(const uint8_t* flags, const uint8_t* literals,
                                const uint8_t* off16, const uint8_t* off24,
                                const int64_t* blocks, const int64_t* chains,
                                int64_t n_chains,
                                int family, uint8_t* out, int32_t* block_len,
                                int32_t* status, void* stream) {
  if (n_chains <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (n_chains + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (family == 0) {
    lz_decode_kernel<0><<<grid, block, 0, s>>>(flags, literals, off16, off24,
                                                blocks, chains, n_chains, out,
                                                block_len, status);
  } else {
    lz_decode_kernel<1><<<grid, block, 0, s>>>(flags, literals, off16, off24,
                                                blocks, chains, n_chains, out,
                                                block_len, status);
  }
  return static_cast<int>(cudaGetLastError());
}
