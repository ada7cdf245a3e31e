// Frozen copy of native/lizard_runtime.cpp at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea: the benchmark's own
// encoder of its decode inputs, xxh32 and frame decoder (h100_bench/native.py).
// lizard_tpu native host runtime: block/frame decode + xxhash.
//
// Original implementation written against the format semantics pinned by the
// Python oracle (lizard_tpu/ref/*); structured as a cursor-based C++ decoder,
// not a translation of the reference C. Used for host-side IO paths (CLI,
// golden verification) where the TPU round-trip is not wanted.
//
// C ABI:
//   ltpu_xxh32(data, len, seed)            -> u32
//   ltpu_xxh64(data, len, seed)            -> u64
//   ltpu_decompress(src, n, dst, cap)      -> bytes written or -errcode
//   ltpu_frame_decompress(src, n, dst, cap)-> bytes written or -errcode

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------- xxhash -----

constexpr uint32_t P32_1 = 2654435761u, P32_2 = 2246822519u, P32_3 = 3266489917u,
                   P32_4 = 668265263u, P32_5 = 374761393u;
constexpr uint64_t P64_1 = 11400714785074694791ull, P64_2 = 14029467366897019727ull,
                   P64_3 = 1609587929392839161ull, P64_4 = 9650029242287828579ull,
                   P64_5 = 2870177450012600261ull;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v; std::memcpy(&v, p, 4); return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v; std::memcpy(&v, p, 8); return v;
}
inline uint32_t rd24(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
}
inline uint32_t rd16(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8);
}

uint32_t xxh32(const uint8_t* p, size_t n, uint32_t seed) {
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + P32_1 + P32_2, v2 = seed + P32_2, v3 = seed,
             v4 = seed - P32_1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + rd32(p) * P32_2, 13) * P32_1; p += 4;
      v2 = rotl32(v2 + rd32(p) * P32_2, 13) * P32_1; p += 4;
      v3 = rotl32(v3 + rd32(p) * P32_2, 13) * P32_1; p += 4;
      v4 = rotl32(v4 + rd32(p) * P32_2, 13) * P32_1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P32_5;
  }
  h += (uint32_t)n;
  while (p + 4 <= end) { h = rotl32(h + rd32(p) * P32_3, 17) * P32_4; p += 4; }
  while (p < end) { h = rotl32(h + (*p++) * P32_5, 11) * P32_1; }
  h ^= h >> 15; h *= P32_2; h ^= h >> 13; h *= P32_3; h ^= h >> 16;
  return h;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  auto rnd = [](uint64_t acc, uint64_t lane) {
    return rotl64(acc + lane * P64_2, 31) * P64_1;
  };
  if (n >= 32) {
    uint64_t v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed,
             v4 = seed - P64_1;
    const uint8_t* limit = end - 32;
    do {
      v1 = rnd(v1, rd64(p)); p += 8;
      v2 = rnd(v2, rd64(p)); p += 8;
      v3 = rnd(v3, rd64(p)); p += 8;
      v4 = rnd(v4, rd64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) { h = (h ^ rnd(0, v)) * P64_1 + P64_4; }
  } else {
    h = seed + P64_5;
  }
  h += n;
  while (p + 8 <= end) { h = rotl64(h ^ rnd(0, rd64(p)), 27) * P64_1 + P64_4; p += 8; }
  if (p + 4 <= end) { h = rotl64(h ^ (rd32(p) * P64_1), 23) * P64_2 + P64_3; p += 4; }
  while (p < end) { h = rotl64(h ^ ((*p++) * P64_5), 11) * P64_1; }
  h ^= h >> 33; h *= P64_2; h ^= h >> 29; h *= P64_3; h ^= h >> 32;
  return h;
}

// ------------------------------------------------------ Huff0 decode ------

struct BitReader {
  // backward bitstream: payload bits below the top set (marker) bit
  const uint8_t* base;
  int64_t bitpos;  // remaining payload bits
  bool bad = false;

  BitReader(const uint8_t* p, size_t n) : base(p) {
    if (n == 0 || p[n - 1] == 0) { bad = true; bitpos = 0; return; }
    int top = 31 - __builtin_clz((uint32_t)p[n - 1]);
    bitpos = (int64_t)(n - 1) * 8 + top;
  }
  uint32_t look(int nbits) const {
    if (nbits == 0) return 0;
    int64_t lo = bitpos - nbits;
    int64_t hb = (bitpos - 1) >> 3;        // highest byte needed
    if (lo >= 0 && hb >= 3) {
      // word path: bits [lo, lo+nbits) from a 4-byte LE load ending at
      // hb (nbits <= 12 so the span fits; shift = lo - 8*(hb-3) is in
      // [0, 31] because lo >= 8*hb - 11 + 1)
      uint32_t w;
      std::memcpy(&w, base + hb - 3, 4);   // LE host
      return (w >> (lo - ((hb - 3) << 3))) & ((1u << nbits) - 1);
    }
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i) {
      int64_t b = lo + i;
      if (b >= 0) {
        v |= (uint32_t)((base[b >> 3] >> (b & 7)) & 1) << i;
      }
    }
    return v;
  }
  uint32_t read(int nbits) { uint32_t v = look(nbits); bitpos -= nbits; return v; }
  bool exhausted_exactly() const { return bitpos == 0; }
  bool overflowed() const { return bitpos < 0; }
};

struct HufTable {
  uint8_t sym[1 << 12];
  uint8_t bits[1 << 12];
  int table_log = 0;
};

// FSE decode for the Huffman weights header
bool fse_decompress_weights(const uint8_t* src, size_t n, uint8_t* out,
                            int max_out, int* n_out) {
  if (n < 4) return false;
  // NCount parse
  auto getbits = [&](int64_t bit, int cnt) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < cnt; ++i) {
      int64_t b = bit + i;
      size_t byte = (size_t)(b >> 3);
      if (byte < n) v |= (uint32_t)((src[byte] >> (b & 7)) & 1) << i;
    }
    return v;
  };
  int64_t bit = 0;
  int table_log = (int)getbits(0, 4) + 5;
  if (table_log > 15) return false;
  bit = 4;
  int remaining = (1 << table_log) + 1;
  int threshold = 1 << table_log;
  int nbits = table_log + 1;
  int16_t counts[256];
  int ncount = 0;
  bool prev0 = false;
  while (remaining > 1 && ncount <= 255) {
    if (prev0) {
      while (getbits(bit, 16) == 0xFFFF) {
        for (int i = 0; i < 24 && ncount < 256; ++i) counts[ncount++] = 0;
        bit += 16;
      }
      while (getbits(bit, 2) == 3) {
        for (int i = 0; i < 3 && ncount < 256; ++i) counts[ncount++] = 0;
        bit += 2;
      }
      uint32_t r = getbits(bit, 2);
      for (uint32_t i = 0; i < r && ncount < 256; ++i) counts[ncount++] = 0;
      bit += 2;
    }
    int maxv = (2 * threshold - 1) - remaining;
    int count;
    if ((int)getbits(bit, 31 - __builtin_clz(threshold)) < maxv) {
      count = (int)getbits(bit, 31 - __builtin_clz(threshold));
      bit += nbits - 1;
    } else {
      count = (int)getbits(bit, nbits);
      if (count >= threshold) count -= maxv;
      bit += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    if (ncount >= 256) return false;
    counts[ncount++] = (int16_t)count;
    prev0 = count == 0;
    while (remaining < threshold) { nbits--; threshold >>= 1; }
  }
  if (remaining != 1) return false;
  size_t consumed = (size_t)((bit + 7) >> 3);
  if (consumed > n) return false;

  // build decode table
  if (table_log > 6) return false;
  int tsize = 1 << table_log;
  uint8_t symbols[64];
  int high = tsize - 1;
  uint16_t sym_next[256];
  for (int s = 0; s < ncount; ++s) {
    if (counts[s] == -1) { symbols[high--] = (uint8_t)s; sym_next[s] = 1; }
    else sym_next[s] = (uint16_t)counts[s];
  }
  int step = (tsize >> 1) + (tsize >> 3) + 3, mask = tsize - 1, pos = 0;
  for (int s = 0; s < ncount; ++s)
    for (int i = 0; i < counts[s]; ++i) {
      symbols[pos] = (uint8_t)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) return false;
  uint8_t tbits[64]; uint16_t tnew[64];
  for (int u = 0; u < tsize; ++u) {
    int s = symbols[u];
    uint16_t next = sym_next[s]++;
    int nb = table_log - (31 - __builtin_clz((uint32_t)next));
    tbits[u] = (uint8_t)nb;
    tnew[u] = (uint16_t)((next << nb) - tsize);
  }

  // two-state interleaved decode
  BitReader br(src + consumed, n - consumed);
  if (br.bad) return false;
  uint32_t s1 = br.read(table_log), s2 = br.read(table_log);
  int outn = 0;
  uint32_t* cur = &s1;
  uint32_t* other = &s2;
  while (true) {
    if (outn >= max_out) return false;
    out[outn++] = symbols[*cur];
    *cur = tnew[*cur] + br.read(tbits[*cur]);
    std::swap(cur, other);
    if (br.overflowed()) {
      if (outn >= max_out) return false;
      out[outn++] = symbols[*cur];
      break;
    }
  }
  *n_out = outn;
  return true;
}

bool huf_build_table(const uint8_t* src, size_t n, HufTable* ht, size_t* hsize) {
  if (n < 1) return false;
  uint8_t weights[256];
  int nweights;
  size_t isize = src[0];
  if (isize >= 128) {
    int osize = (int)isize - 127;
    isize = (size_t)((osize + 1) / 2);
    if (isize + 1 > n) return false;
    for (int i = 0; i < osize; ++i)
      weights[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    nweights = osize;
  } else {
    if (isize + 1 > n) return false;
    if (!fse_decompress_weights(src + 1, isize, weights, 255, &nweights))
      return false;
  }
  *hsize = isize + 1;

  uint32_t total = 0;
  for (int i = 0; i < nweights; ++i) {
    if (weights[i] >= 12) return false;
    total += weights[i] ? (1u << (weights[i] - 1)) : 0;
  }
  if (total == 0) return false;
  int table_log = (31 - __builtin_clz(total)) + 1;
  if (table_log > 12) return false;
  uint32_t rest = (1u << table_log) - total;
  if (rest & (rest - 1)) return false;
  weights[nweights++] = (uint8_t)((31 - __builtin_clz(rest)) + 1);

  // canonical single-symbol table
  uint32_t rank_count[14] = {0}, rank_next[14] = {0};
  for (int i = 0; i < nweights; ++i) rank_count[weights[i]]++;
  uint32_t start = 0;
  for (int w = 1; w <= table_log; ++w) {
    rank_next[w] = start;
    start += rank_count[w] << (w - 1);
  }
  ht->table_log = table_log;
  for (int s = 0; s < nweights; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = 1u << (w - 1);
    uint8_t nb = (uint8_t)(table_log + 1 - w);
    for (uint32_t i = rank_next[w]; i < rank_next[w] + len; ++i) {
      ht->sym[i] = (uint8_t)s;
      ht->bits[i] = nb;
    }
    rank_next[w] += len;
  }
  return true;
}

bool huf_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_size) {
  if (dst_size == 0 || n > dst_size) return false;
  if (n == dst_size) { std::memcpy(dst, src, n); return true; }
  if (n == 1) { std::memset(dst, src[0], dst_size); return true; }
  HufTable ht;
  size_t hsize;
  if (!huf_build_table(src, n, &ht, &hsize)) return false;
  if (hsize + 10 > n) return false;
  const uint8_t* body = src + hsize;
  size_t bn = n - hsize;
  size_t l1 = rd16(body), l2 = rd16(body + 2), l3 = rd16(body + 4);
  if (6 + l1 + l2 + l3 > bn) return false;
  size_t l4 = bn - 6 - l1 - l2 - l3;
  size_t seg = (dst_size + 3) / 4;
  const uint8_t* ps[4] = {body + 6, body + 6 + l1, body + 6 + l1 + l2,
                          body + 6 + l1 + l2 + l3};
  size_t ls[4] = {l1, l2, l3, l4};
  size_t outs[4] = {seg, seg, seg, dst_size - 3 * seg};
  // fused entry (sym | bits<<8) so the hot loop does one table load
  const int tl = ht.table_log;
  uint16_t dtab[1 << 12];
  for (uint32_t v = 0; v < (1u << tl); ++v)
    dtab[v] = (uint16_t)(ht.sym[v] | (ht.bits[v] << 8));
  // double-symbol table (huf_decompress.c X4 idea): when the second
  // code fits in the remaining tl-nb1 bits, one lookup emits 2 symbols.
  // v's HIGH bits hold the first code; the second slot is v's low
  // tl-nb1 bits shifted up (any fill of its own low bits stays inside
  // one code range since 2^(tl-nb2) >= 2^nb1).
  // entry: sym1 | sym2<<8 | nbits<<16 | (nsyms-1)<<21
  uint32_t dtab2[1 << 12];
  for (uint32_t v = 0; v < (1u << tl); ++v) {
    uint32_t nb1 = ht.bits[v];
    uint32_t e = ht.sym[v] | (nb1 << 16);
    if (nb1 > 0 && nb1 < (uint32_t)tl) {
      uint32_t v2 = (v << nb1) & ((1u << tl) - 1);
      uint32_t nb2 = ht.bits[v2];
      if (nb2 > 0 && nb1 + nb2 <= (uint32_t)tl)
        e = ht.sym[v] | (ht.sym[v2] << 8) | ((nb1 + nb2) << 16) |
            (1u << 21);
    }
    dtab2[v] = e;
  }
  // with a 64-bit container reloaded to end at the highest needed byte,
  // accbase >= bitpos-63 and each peek needs lo = bitpos-tl >= accbase:
  // 4 symbols per reload are safe for tl <= 11, 3 for tl = 12
  const int spr = tl <= 11 ? 4 : 3;
  const uint32_t mask = (1u << tl) - 1;
  BitReader br0(ps[0], ls[0]), br1(ps[1], ls[1]);
  BitReader br2(ps[2], ls[2]), br3(ps[3], ls[3]);
  BitReader* brs[4] = {&br0, &br1, &br2, &br3};
  uint8_t* ds[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  for (int k = 0; k < 4; ++k)
    if (brs[k]->bad) return false;
  // lockstep across the 4 independent streams (4 dependency chains in
  // flight -- the per-symbol bitpos->shift->load chain is the bound);
  // each lookup consumes <= tl bits and emits 1-2 symbols (sym2 is
  // written unconditionally and overwritten when nsyms == 1)
  size_t os[4] = {0, 0, 0, 0};
  while (os[0] + 2 * (size_t)spr <= outs[0] &&
         os[1] + 2 * (size_t)spr <= outs[1] &&
         os[2] + 2 * (size_t)spr <= outs[2] &&
         os[3] + 2 * (size_t)spr <= outs[3] &&
         br0.bitpos >= 64 && br1.bitpos >= 64 &&
         br2.bitpos >= 64 && br3.bitpos >= 64) {
    uint64_t a0, a1, a2, a3;
    int64_t b0 = ((br0.bitpos - 1) >> 3) - 7;
    int64_t b1 = ((br1.bitpos - 1) >> 3) - 7;
    int64_t b2 = ((br2.bitpos - 1) >> 3) - 7;
    int64_t b3 = ((br3.bitpos - 1) >> 3) - 7;
    std::memcpy(&a0, br0.base + b0, 8);            // LE host
    std::memcpy(&a1, br1.base + b1, 8);
    std::memcpy(&a2, br2.base + b2, 8);
    std::memcpy(&a3, br3.base + b3, 8);
    int64_t p0 = br0.bitpos - (b0 << 3) - tl;
    int64_t p1 = br1.bitpos - (b1 << 3) - tl;
    int64_t p2 = br2.bitpos - (b2 << 3) - tl;
    int64_t p3 = br3.bitpos - (b3 << 3) - tl;
    uint8_t* d0 = ds[0] + os[0];
    uint8_t* d1 = ds[1] + os[1];
    uint8_t* d2 = ds[2] + os[2];
    uint8_t* d3 = ds[3] + os[3];
    for (int j = 0; j < spr; ++j) {
      uint32_t e0 = dtab2[(uint32_t)(a0 >> p0) & mask];
      uint32_t e1 = dtab2[(uint32_t)(a1 >> p1) & mask];
      uint32_t e2 = dtab2[(uint32_t)(a2 >> p2) & mask];
      uint32_t e3 = dtab2[(uint32_t)(a3 >> p3) & mask];
      d0[0] = (uint8_t)e0; d0[1] = (uint8_t)(e0 >> 8);
      d1[0] = (uint8_t)e1; d1[1] = (uint8_t)(e1 >> 8);
      d2[0] = (uint8_t)e2; d2[1] = (uint8_t)(e2 >> 8);
      d3[0] = (uint8_t)e3; d3[1] = (uint8_t)(e3 >> 8);
      d0 += 1 + (e0 >> 21); p0 -= (e0 >> 16) & 31;
      d1 += 1 + (e1 >> 21); p1 -= (e1 >> 16) & 31;
      d2 += 1 + (e2 >> 21); p2 -= (e2 >> 16) & 31;
      d3 += 1 + (e3 >> 21); p3 -= (e3 >> 16) & 31;
    }
    br0.bitpos = p0 + (b0 << 3) + tl;
    br1.bitpos = p1 + (b1 << 3) + tl;
    br2.bitpos = p2 + (b2 << 3) + tl;
    br3.bitpos = p3 + (b3 << 3) + tl;
    os[0] = (size_t)(d0 - ds[0]);
    os[1] = (size_t)(d1 - ds[1]);
    os[2] = (size_t)(d2 - ds[2]);
    os[3] = (size_t)(d3 - ds[3]);
  }
  // per-stream tails (and any stream the lockstep loop never entered)
  for (int k = 0; k < 4; ++k) {
    BitReader& br = *brs[k];
    uint8_t* d = ds[k];
    size_t n_out = outs[k];
    for (size_t ik = os[k]; ik < n_out; ++ik) {
      uint32_t v = br.look(tl);
      uint16_t e = dtab[v];
      d[ik] = (uint8_t)e;
      br.bitpos -= e >> 8;
    }
    if (!br.exhausted_exactly()) return false;
  }
  return true;
}

// ------------------------------------------------------ block decode ------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  size_t left() const { return (size_t)(end - p); }
};

// 16-byte-stepped copy; may write up to 15 bytes past d+n (caller
// guarantees slack). Source must not overlap [d, d+n+15].
inline void wildcopy16(uint8_t* d, const uint8_t* s, size_t n) {
  do {
    std::memcpy(d, s, 16);
    d += 16;
    s += 16;
  } while (n > 16 && (n -= 16));
}

// 8-byte-stepped overlap-tolerant match copy for offsets >= 8; may
// write up to 7 bytes past d+n (caller guarantees slack).
inline void matchcopy8(uint8_t* d, const uint8_t* s, size_t n) {
  do {
    std::memcpy(d, s, 8);
    d += 8;
    s += 8;
  } while (n > 8 && (n -= 8));
}

// read one length extension from the literal cursor
inline bool read_ext(Cursor& lit, uint32_t base, uint32_t* out) {
  if (lit.left() < 1) return false;
  uint32_t b0 = *lit.p;
  if (b0 < 254) { *out = base + b0; lit.p += 1; return true; }
  if (b0 == 254) {
    if (lit.left() < 3) return false;
    *out = base + rd16(lit.p + 1); lit.p += 3; return true;
  }
  if (lit.left() < 4) return false;
  *out = base + rd24(lit.p + 1); lit.p += 4; return true;
}

// family selected by level: 10-19 / 30-39 => LZ4 codewords
inline bool level_is_lz4(int level) {
  return (level >= 10 && level <= 19) || (level >= 30 && level <= 39);
}

int64_t decode_block_lz4(Cursor flags, Cursor lit, uint8_t* dst, size_t dpos,
                         size_t dcap, size_t window_base) {
  while (flags.p < flags.end) {
    uint32_t token = *flags.p++;
    uint32_t ll = token & 15;
    if (ll == 15 && !read_ext(lit, 15, &ll)) return -2;
    if (lit.left() < (size_t)ll + 2 || dpos + ll > dcap) return -2;
    if (ll) {
      if (dpos + ll + 16 <= dcap && lit.left() >= (size_t)ll + 18)
        wildcopy16(dst + dpos, lit.p, ll);
      else
        std::memcpy(dst + dpos, lit.p, ll);
      lit.p += ll;
      dpos += ll;
    }
    uint32_t off = rd16(lit.p);
    lit.p += 2;
    uint32_t ml = token >> 4;
    if (ml == 15 && !read_ext(lit, 15, &ml)) return -2;
    ml += 4;
    if (off == 0 || dpos < window_base + off || dpos + ml > dcap) return -2;
    const uint8_t* s = dst + dpos - off;
    uint8_t* d = dst + dpos;
    if (off >= 16 && dpos + ml + 16 <= dcap)
      wildcopy16(d, s, ml);            // overlap-tolerant at off >= 16
    else if (off >= 8 && dpos + ml + 8 <= dcap)
      matchcopy8(d, s, ml);            // overlap-tolerant at off >= 8
    else if (off >= ml)
      std::memcpy(d, s, ml);
    else
      for (uint32_t i = 0; i < ml; ++i) d[i] = s[i];
    dpos += ml;
  }
  size_t tail = lit.left();
  if (dpos + tail > dcap) return -2;
  std::memcpy(dst + dpos, lit.p, tail);
  return (int64_t)(dpos + tail);
}

int64_t decode_block_liz(Cursor flags, Cursor lit, Cursor off16, Cursor off24,
                         uint8_t* dst, size_t dpos, size_t dcap,
                         size_t window_base) {
  int64_t last_off = 0;
  while (flags.p < flags.end) {
    uint32_t token = *flags.p++;
    uint32_t ll = 0, ml;
    if (token >= 32) {
      ll = token & 7;
      if (ll == 7 && !read_ext(lit, 7, &ll)) return -2;
      if (lit.left() < ll || dpos + ll > dcap) return -2;
      if (ll) {
        if (dpos + ll + 16 <= dcap && lit.left() >= (size_t)ll + 16)
          wildcopy16(dst + dpos, lit.p, ll);
        else
          std::memcpy(dst + dpos, lit.p, ll);
        lit.p += ll;
        dpos += ll;
      }
      if (token < 128) {  // new 16-bit offset
        if (off16.left() < 2) return -2;
        last_off = rd16(off16.p);
        off16.p += 2;
      }
      ml = (token >> 3) & 15;
      if (ml == 15 && !read_ext(lit, 15, &ml)) return -2;
    } else if (token < 31) {
      if (off24.left() < 3) return -2;
      ml = token + 16;
      last_off = rd24(off24.p);
      off24.p += 3;
    } else {
      if (!read_ext(lit, 0, &ml)) return -2;
      ml += 31 + 16;
      if (off24.left() < 3) return -2;
      last_off = rd24(off24.p);
      off24.p += 3;
    }
    if (last_off == 0) {
      if (ml != 0) return -2;  // zero-length rep placeholder token
      continue;
    }
    if (dpos < window_base + (size_t)last_off || dpos + ml > dcap) return -2;
    const uint8_t* s = dst + dpos - last_off;
    uint8_t* d = dst + dpos;
    if (last_off >= 16 && dpos + ml + 16 <= dcap)
      wildcopy16(d, s, ml);            // overlap-tolerant at off >= 16
    else if (last_off >= 8 && dpos + ml + 8 <= dcap)
      matchcopy8(d, s, ml);            // overlap-tolerant at off >= 8
    else if ((uint64_t)last_off >= ml)
      std::memcpy(d, s, ml);
    else
      for (uint32_t i = 0; i < ml; ++i) d[i] = s[i];
    dpos += ml;
  }
  size_t tail = lit.left();
  if (dpos + tail > dcap) return -2;
  std::memcpy(dst + dpos, lit.p, tail);
  return (int64_t)(dpos + tail);
}

// stream reader: raw (LE24 len) or Huffman (LE24 orig + LE24 comp + blob)
bool read_stream(const uint8_t*& ip, const uint8_t* iend, bool huff,
                 std::vector<uint8_t>& scratch, Cursor* out) {
  if (!huff) {
    if (ip + 3 > iend) return false;
    uint32_t len = rd24(ip);
    if (ip + 3 + len > iend) return false;
    out->p = ip + 3;
    out->end = ip + 3 + len;
    ip += 3 + len;
    return true;
  }
  if (ip + 6 > iend) return false;
  uint32_t orig = rd24(ip), comp = rd24(ip + 3);
  if (ip + 6 + comp > iend || orig > (1u << 17)) return false;
  size_t base = scratch.size();
  scratch.resize(base + orig);
  if (!huf_decompress(ip + 6, comp, scratch.data() + base, orig)) return false;
  // note: scratch may reallocate; caller resolves pointers afterwards
  out->p = (const uint8_t*)(uintptr_t)base;       // offset, fixed up later
  out->end = (const uint8_t*)(uintptr_t)(base + orig);
  ip += 6 + comp;
  return true;
}

int64_t decompress_stream(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t dcap, size_t dpos0, size_t window_base) {
  if (n < 1) return -1;
  int level = src[0];
  if (level < 10 || level > 49) return -1;
  bool lz4 = level_is_lz4(level);

  const uint8_t* ip = src + 1;
  const uint8_t* iend = src + n;
  size_t dpos = dpos0;
  std::vector<uint8_t> scratch;

  while (ip < iend) {
    uint32_t header = *ip++;
    if (header == 128) {  // stored block
      if (ip + 3 > iend) return -1;
      uint32_t len = rd24(ip);
      ip += 3;
      if (ip + len > iend || dpos + len > dcap) return -1;
      std::memcpy(dst + dpos, ip, len);
      dpos += len;
      ip += len;
      continue;
    }
    if (header & 16) return -1;            // FLAG_LEN is never set
    if (header & ~(uint32_t)(1 + 2 + 4 + 8)) return -1;

    scratch.clear();
    Cursor lens, o16, o24, fl, lits;
    bool h16 = header & 4, h24 = header & 8, hfl = header & 2, hlit = header & 1;
    bool hufs[5] = {false, h16, h24, hfl, hlit};
    Cursor* cs[5] = {&lens, &o16, &o24, &fl, &lits};
    for (int k = 0; k < 5; ++k)
      if (!read_stream(ip, iend, hufs[k], scratch, cs[k])) return -1;
    // fix up scratch-relative cursors after all allocations are done
    for (int k = 0; k < 5; ++k) {
      if (hufs[k]) {
        size_t b = (size_t)(uintptr_t)cs[k]->p, e = (size_t)(uintptr_t)cs[k]->end;
        cs[k]->p = scratch.data() + b;
        cs[k]->end = scratch.data() + e;
      }
    }

    int64_t r = lz4 ? decode_block_lz4(fl, lits, dst, dpos, dcap, window_base)
                    : decode_block_liz(fl, lits, o16, o24, dst, dpos, dcap,
                                       window_base);
    if (r < 0) return r;
    dpos = (size_t)r;
  }
  return (int64_t)(dpos - dpos0);
}

}  // namespace

extern "C" {

uint32_t ltpu_xxh32(const uint8_t* p, size_t n, uint32_t seed) {
  return xxh32(p, n, seed);
}
uint64_t ltpu_xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  return xxh64(p, n, seed);
}

int64_t ltpu_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  return decompress_stream(src, n, dst, cap, 0, 0);
}

// Frame decode (doc/lizard_Frame_format.md): magic, descriptor, blocks,
// endmark, optional xxh32 content checksum. Returns bytes written or <0.
int64_t ltpu_frame_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                              size_t cap) {
  size_t p = 0, dpos = 0;
  while (p < n) {
    if (p + 4 > n) return -1;
    uint32_t magic = rd32(src + p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (p + 8 > n) return -1;
      p += 8 + rd32(src + p + 4);
      continue;
    }
    if (magic != 0x184D2206u) return -1;
    p += 4;
    if (p + 3 > n) return -1;
    uint8_t flg = src[p], bd = src[p + 1];
    if (((flg >> 6) & 3) != 1 || (flg & 3) || (bd & 0x8F)) return -1;
    bool linked = ((flg >> 5) & 1) == 0;
    bool has_crc = (flg >> 2) & 1;
    bool has_size = (flg >> 3) & 1;
    size_t hlen = has_size ? 10 : 2;
    if (p + hlen + 1 > n) return -1;
    uint8_t hc = src[p + hlen];
    if (((xxh32(src + p, hlen, 0) >> 8) & 0xFF) != hc) return -1;
    p += hlen + 1;

    size_t frame_start = dpos;
    while (true) {
      if (p + 4 > n) return -1;
      uint32_t bsize = rd32(src + p);
      p += 4;
      if (bsize == 0) break;
      bool stored = bsize & 0x80000000u;
      bsize &= 0x7FFFFFFFu;
      if (p + bsize > n) return -1;
      if (stored) {
        if (dpos + bsize > cap) return -1;
        std::memcpy(dst + dpos, src + p, bsize);
        dpos += bsize;
      } else {
        int64_t r = decompress_stream(src + p, bsize, dst, cap, dpos,
                                      linked ? frame_start : dpos);
        if (r < 0) return r;
        dpos += (size_t)r;
      }
      p += bsize;
    }
    if (has_crc) {
      if (p + 4 > n) return -1;
      if (xxh32(dst + frame_start, dpos - frame_start, 0) != rd32(src + p))
        return -3;
      p += 4;
    }
  }
  return (int64_t)dpos;
}

}  // extern "C"

// ===========================================================================
// fastLZ4-family block-stream ENCODER (written from scratch against the
// format spec, doc/lizard_Block_format.md + lib/lizard_compress_lz4.h
// semantics): greedy hash match finder with LZ4-style skip acceleration and
// backward extension, emitting the two raw streams (flags + literals) per
// 128 KB inner block. Output is a valid stream for any fastLZ4 level byte;
// it is NOT byte-identical to the reference encoder (the bit-exact encoder
// lives in lizard_tpu/ref/block_encode.py) -- this is the fast host path.
// ===========================================================================
namespace {

constexpr size_t kBlock = 131072;            // LIZARD_BLOCK_SIZE
constexpr uint32_t kMaxOff = 65535;
constexpr size_t kLastLiterals = 16;         // decoder tail rule slack
constexpr uint8_t kFlagUncompressed = 128;   // lizard_common.h LIZARD_FLAG_UNCOMPRESSED

inline uint32_t ehash(uint32_t v, int hlog) {
  return (v * 2654435761u) >> (32 - hlog);
}

// append a length-extension (<254 | 254+LE16 | 255+LE24)
inline void put_ext(std::vector<uint8_t>& out, uint32_t v) {
  if (v < 254) {
    out.push_back((uint8_t)v);
  } else if (v < 65536) {
    out.push_back(254);
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
  } else {
    out.push_back(255);
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
    out.push_back((uint8_t)(v >> 16));
  }
}

inline void put_le24(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((uint8_t)v);
  out.push_back((uint8_t)(v >> 8));
  out.push_back((uint8_t)(v >> 16));
}

struct EncAcc {
  std::vector<uint8_t> flags, lits;
};

// encode src[b0, b1) as one inner block's token streams; the hash table
// holds absolute positions into src (window shared across inner blocks of
// the same call, like one Lizard raw stream, lizard_compress.c:494-540)
void encode_inner_lz4(const uint8_t* src, size_t b0, size_t b1, size_t n,
                      uint32_t* htab, int hlog, int accel, EncAcc& acc) {
  acc.flags.clear();
  acc.lits.clear();
  size_t ip = b0, anchor = b0;
  // matches must stop so that every in-loop literal run leaves >= 2+16
  // bytes in the literal stream (decoder rule lizard_decompress_lz4.h:104)
  size_t mflimit = (b1 >= 20 && b1 - 20 >= b0) ? b1 - 20 : b0;

  auto emit = [&](size_t lit_end, size_t mpos, size_t mlen, uint32_t off) {
    size_t ll = lit_end - anchor;
    uint32_t ml = (uint32_t)mlen - 4;
    uint8_t tok = (uint8_t)(((ml < 15 ? ml : 15) << 4) |
                            (ll < 15 ? (uint8_t)ll : 15));
    acc.flags.push_back(tok);
    if (ll >= 15) put_ext(acc.lits, (uint32_t)(ll - 15));
    acc.lits.insert(acc.lits.end(), src + anchor, src + anchor + ll);
    acc.lits.push_back((uint8_t)off);
    acc.lits.push_back((uint8_t)(off >> 8));
    if (ml >= 15) put_ext(acc.lits, ml - 15);
    (void)mpos;
  };

  if (b1 - b0 > 24) {
    uint32_t searches = 0;
    while (ip < mflimit) {
      uint32_t v = rd32(src + ip);
      uint32_t h = ehash(v, hlog);
      size_t cand = htab[h];
      htab[h] = (uint32_t)ip;
      // LIZARD_FAST_MIN_OFFSET: the fastLZ4 decoder's unconditional
      // 8-byte copies require offsets >= 8 (lizard_parser_fast.h:1)
      if (cand + 8 <= ip && ip - cand <= kMaxOff && cand < n &&
          rd32(src + cand) == v) {
        // backward extension
        size_t mp = cand, mq = ip;
        while (mq > anchor && mp > 0 && src[mp - 1] == src[mq - 1]) {
          --mp;
          --mq;
        }
        // (backward extension preserves the offset, so >= 8 still holds)
        // forward extension
        size_t len = 4;
        size_t maxl = b1 - kLastLiterals - mq;
        while (len < maxl && src[mp + len] == src[mq + len]) ++len;
        if (len >= 4) {
          emit(mq, mp, len, (uint32_t)(mq - mp));
          anchor = mq + len;
          ip = anchor;
          searches = 0;
          // insert a couple of positions inside the match for future refs
          if (ip - 2 > b0 && ip < mflimit) {
            htab[ehash(rd32(src + ip - 2), hlog)] = (uint32_t)(ip - 2);
          }
          continue;
        }
      }
      ip += 1 + (searches++ >> (6 + (accel > 1 ? accel - 1 : 0)));
    }
  }
  // trailing literals: the remainder of the block, raw
  acc.lits.insert(acc.lits.end(), src + anchor, src + b1);
}

}  // namespace

extern "C" {

// Compress `src` into a Lizard block stream (level byte + inner blocks with
// raw flags/literals streams). level must be a fastLZ4-family level
// (10..19 or 30..39 -- written verbatim; streams are raw so any of them
// decodes it). accel >= 1 trades ratio for speed. Returns bytes written or
// -1 if dst is too small.
int64_t ltpu_compress_lz4(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t cap, int level, int accel) {
  int hlog = 17;
  std::vector<uint32_t> htab((size_t)1 << hlog, 0xFFFFFFFFu);
  // position 0 sentinel: fill with large value so "cand < ip" rejects
  std::vector<uint8_t> out;
  out.reserve(n / 2 + 1024);
  out.push_back((uint8_t)level);
  EncAcc acc;
  for (size_t b0 = 0; b0 < n || (n == 0 && b0 == 0); b0 += kBlock) {
    size_t b1 = b0 + kBlock < n ? b0 + kBlock : n;
    encode_inner_lz4(src, b0, b1, n, htab.data(), hlog, accel, acc);
    size_t comp = 1 + 5 * 3 + acc.flags.size() + acc.lits.size();
    size_t raw = b1 - b0;
    if (raw > 0 && comp >= raw - (raw >> 6)) {
      // insufficient gain: stored block (lizard_compress.c:235-245)
      out.push_back(kFlagUncompressed);
      put_le24(out, (uint32_t)raw);
      out.insert(out.end(), src + b0, src + b1);
    } else {
      // header byte 0: all five streams raw
      out.push_back(0);
      put_le24(out, 0);                          // len stream (empty)
      put_le24(out, 0);                          // off16 (empty)
      put_le24(out, 0);                          // off24 (empty)
      put_le24(out, (uint32_t)acc.flags.size()); // flags
      out.insert(out.end(), acc.flags.begin(), acc.flags.end());
      put_le24(out, (uint32_t)acc.lits.size());  // literals
      out.insert(out.end(), acc.lits.begin(), acc.lits.end());
    }
    if (n == 0) break;
  }
  if (out.size() > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return (int64_t)out.size();
}

}  // extern "C"

extern "C" {
// standalone Huff0 decode (for the host-side stream splitter)
int ltpu_huf_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t dst_size) {
  return huf_decompress(src, n, dst, dst_size) ? 0 : -1;
}
}

// ===========================================================================
// Huff0 ENCODER (host). A C++ port of this repo's own bit-exact Python
// oracle (lizard_tpu/ref/huf_encode.py, itself written against
// lib/entropy/huf_compress.c semantics): canonical Huffman with
// setMaxHeight(11), CTable serialized as FSE-compressed weights with the
// 4-bit-nibble fallback, and the 4-stream body with LE16 jump table.
// Output decodes with both this file's huf_decompress and liblizard.
// ===========================================================================
namespace hufenc {

constexpr int kHufTableLogMax = 12;
constexpr int kHufTableLogDefault = 11;
constexpr int kFseMinTableLog = 5;
constexpr int kFseMaxTableLog = 12;

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

struct BW {
  // BIT_CStream_t model: LSB-first concat, close() appends the end-mark
  // bit. Bits batch in a 64-bit accumulator and flush whole bytes with
  // one 8-byte store (the byte-at-a-time push_back variant measured
  // 96 MB/s; this one >500 MB/s). Safe for add() of up to 32 bits: the
  // accumulator is drained below 32 pending bits after every add.
  std::vector<uint8_t> buf;
  size_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  inline void add(uint32_t v, int nb) {
    acc |= (uint64_t)(v & ((nb < 32 ? (1u << nb) : 0u) - 1u)) << nbits;
    nbits += nb;
    if (nbits >= 32) flush();
  }
  inline void flush() {
    if (buf.size() < pos + 16) buf.resize((pos + 16) * 2);
    std::memcpy(buf.data() + pos, &acc, 8);       // LE host
    int k = nbits >> 3;
    pos += (size_t)k;
    acc >>= 8 * k;
    nbits &= 7;
  }
  // hot-path pair (huf_encode_1x): codes are pre-masked table values
  // and the caller pre-sizes buf, so neither the mask nor the resize
  // check is needed; 4 codes of <= 11 bits batch between flushes
  // (7 + 44 <= 64)
  inline void add_fast(uint32_t v, int nb) {
    acc |= (uint64_t)v << nbits;
    nbits += nb;
  }
  inline void flush_unchecked() {
    std::memcpy(buf.data() + pos, &acc, 8);
    int k = nbits >> 3;
    pos += (size_t)k;
    acc >>= 8 * k;
    nbits &= 7;
  }
  inline void close() {
    add(1, 1);
    flush();
    if (nbits) {
      if (buf.size() < pos + 1) buf.resize(pos + 8);
      buf[pos++] = (uint8_t)acc;
      acc = 0;
      nbits = 0;
    }
    buf.resize(pos);
  }
};

inline int fse_min_table_log(size_t src_size, int max_sym) {
  int min_bits_src = highbit32((uint32_t)(src_size - 1)) + 1;
  int min_bits_symbols = highbit32((uint32_t)max_sym) + 2;
  return min_bits_src < min_bits_symbols ? min_bits_src : min_bits_symbols;
}

inline int fse_optimal_table_log(int max_table_log, size_t src_size,
                                 int max_sym, int minus) {
  int max_bits_src = highbit32((uint32_t)(src_size - 1)) - minus;
  int table_log = max_table_log ? max_table_log : 11;
  if (max_bits_src < table_log) table_log = max_bits_src;
  int min_bits = fse_min_table_log(src_size, max_sym);
  if (min_bits > table_log) table_log = min_bits;
  if (table_log < kFseMinTableLog) table_log = kFseMinTableLog;
  if (table_log > kFseMaxTableLog) table_log = kFseMaxTableLog;
  return table_log;
}

static const uint32_t kRtb[8] = {0,      473195, 504333, 520860,
                                 550000, 700000, 750000, 830000};

// FSE_normalizeCount; returns false for the rle case
inline bool fse_normalize_count(int table_log, const uint32_t* count,
                                size_t total, int max_sym, int16_t* norm) {
  int scale = 62 - table_log;
  uint64_t step = (1ull << 62) / total;
  uint64_t v_step = 1ull << (scale - 20);
  int64_t still = 1ll << table_log;
  int largest = 0;
  int64_t largest_p = 0;
  uint32_t low_threshold = (uint32_t)(total >> table_log);

  for (int s = 0; s <= max_sym; ++s) {
    uint32_t c = count[s];
    if (c == total) return false;  // rle
    if (c == 0) {
      norm[s] = 0;
      continue;
    }
    if (c <= low_threshold) {
      norm[s] = -1;
      still -= 1;
    } else {
      int64_t proba = (int64_t)(((unsigned __int128)c * step) >> scale);
      if (proba < 8) {
        uint64_t rest_to_beat = v_step * kRtb[proba];
        if ((unsigned __int128)c * step - ((unsigned __int128)proba << scale) >
            rest_to_beat)
          proba += 1;
      }
      if (proba > largest_p) {
        largest_p = proba;
        largest = s;
      }
      norm[s] = (int16_t)proba;
      still -= proba;
    }
  }

  if (-still >= (norm[largest] >> 1)) {
    // FSE_normalizeM2
    int64_t tot = (int64_t)total;
    int distributed = 0;
    int64_t low_one = ((int64_t)total * 3) >> (table_log + 1);
    for (int s = 0; s <= max_sym; ++s) {
      if (count[s] == 0) {
        norm[s] = 0;
        continue;
      }
      if (count[s] <= low_threshold) {
        norm[s] = -1;
        distributed++;
        tot -= count[s];
        continue;
      }
      if ((int64_t)count[s] <= low_one) {
        norm[s] = 1;
        distributed++;
        tot -= count[s];
        continue;
      }
      norm[s] = -2;
    }
    int64_t to_distribute = (1ll << table_log) - distributed;
    if (to_distribute && tot / to_distribute > low_one) {
      low_one = (tot * 3) / (to_distribute * 2);
      for (int s = 0; s <= max_sym; ++s) {
        if (norm[s] == -2 && (int64_t)count[s] <= low_one) {
          norm[s] = 1;
          distributed++;
          tot -= count[s];
        }
      }
      to_distribute = (1ll << table_log) - distributed;
    }
    if (distributed == max_sym + 1) {
      int max_v = 0;
      uint32_t max_c = 0;
      for (int s = 0; s <= max_sym; ++s)
        if (count[s] > max_c) {
          max_v = s;
          max_c = count[s];
        }
      norm[max_v] = (int16_t)(norm[max_v] + to_distribute);
      return true;
    }
    int v_step_log = 62 - table_log;
    uint64_t mid = (1ull << (v_step_log - 1)) - 1;
    uint64_t r_step = (((1ull << v_step_log) * to_distribute) + mid) / tot;
    uint64_t tmp_total = mid;
    for (int s = 0; s <= max_sym; ++s) {
      if (norm[s] == -2) {
        uint64_t end = tmp_total + count[s] * r_step;
        int weight =
            (int)((end >> v_step_log) - (tmp_total >> v_step_log));
        if (weight < 1) return false;
        norm[s] = (int16_t)weight;
        tmp_total = end;
      }
    }
  } else {
    norm[largest] = (int16_t)(norm[largest] + still);
  }
  return true;
}

inline bool fse_write_ncount(const int16_t* norm, int max_sym, int table_log,
                             std::vector<uint8_t>& out) {
  uint64_t bit_stream = (uint64_t)(table_log - kFseMinTableLog);
  int bit_count = 4;
  int remaining = (1 << table_log) + 1;
  int threshold = 1 << table_log;
  int nb_bits = table_log + 1;
  int charnum = 0;
  bool previous0 = false;

  while (remaining > 1) {
    if (previous0) {
      int start = charnum;
      while (!norm[charnum]) charnum++;
      while (charnum >= start + 24) {
        start += 24;
        bit_stream += 0xFFFFull << bit_count;
        out.push_back((uint8_t)bit_stream);
        out.push_back((uint8_t)(bit_stream >> 8));
        bit_stream >>= 16;
      }
      while (charnum >= start + 3) {
        start += 3;
        bit_stream += 3ull << bit_count;
        bit_count += 2;
      }
      bit_stream += (uint64_t)(charnum - start) << bit_count;
      bit_count += 2;
      if (bit_count > 16) {
        out.push_back((uint8_t)bit_stream);
        out.push_back((uint8_t)(bit_stream >> 8));
        bit_stream >>= 16;
        bit_count -= 16;
      }
    }
    int count = norm[charnum];
    charnum++;
    int maxv = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;
    if (count >= threshold) count += maxv;
    bit_stream += (uint64_t)count << bit_count;
    bit_count += nb_bits;
    if (count < maxv) bit_count -= 1;
    previous0 = count == 1;
    if (remaining < 1) return false;
    while (remaining < threshold) {
      nb_bits--;
      threshold >>= 1;
    }
    if (bit_count > 16) {
      out.push_back((uint8_t)bit_stream);
      out.push_back((uint8_t)(bit_stream >> 8));
      bit_stream >>= 16;
      bit_count -= 16;
    }
  }
  out.push_back((uint8_t)bit_stream);
  out.push_back((uint8_t)(bit_stream >> 8));
  size_t n = out.size() - 2 + (size_t)((bit_count + 7) / 8);
  if (charnum > max_sym + 1) return false;
  out.resize(n);
  return true;
}

struct FseCT {
  int table_log;
  uint16_t state_table[1 << kFseMaxTableLog];
  int32_t delta_nb_bits[256];
  int32_t delta_find_state[256];
};

inline bool fse_build_ctable(const int16_t* norm, int max_sym, int table_log,
                             FseCT& ct) {
  int table_size = 1 << table_log;
  ct.table_log = table_log;
  int high = table_size - 1;
  int cumul[258];
  std::vector<uint8_t> table_symbol(table_size);
  cumul[0] = 0;
  for (int u = 1; u <= max_sym + 1; ++u) {
    if (norm[u - 1] == -1) {
      cumul[u] = cumul[u - 1] + 1;
      table_symbol[high--] = (uint8_t)(u - 1);
    } else {
      cumul[u] = cumul[u - 1] + norm[u - 1];
    }
  }
  cumul[max_sym + 1] = table_size + 1;

  int step = (table_size >> 1) + (table_size >> 3) + 3;
  int mask = table_size - 1;
  int pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < (norm[s] > 0 ? norm[s] : 0); ++i) {
      table_symbol[pos] = (uint8_t)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) return false;

  for (int u = 0; u < table_size; ++u) {
    int s = table_symbol[u];
    ct.state_table[cumul[s]++] = (uint16_t)(table_size + u);
  }

  int total = 0;
  for (int s = 0; s <= max_sym; ++s) {
    int n = norm[s];
    if (n == 0) {
      ct.delta_nb_bits[s] = 0;
      ct.delta_find_state[s] = 0;
      continue;
    }
    if (n == -1 || n == 1) {
      ct.delta_nb_bits[s] = (table_log << 16) - (1 << table_log);
      ct.delta_find_state[s] = total - 1;
      total += 1;
    } else {
      int max_bits_out = table_log - highbit32((uint32_t)(n - 1));
      int min_state_plus = n << max_bits_out;
      ct.delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus;
      ct.delta_find_state[s] = total - n;
      total += n;
    }
  }
  return true;
}

struct FseCState {
  int32_t value;
  inline void init(const FseCT& ct, uint8_t s) {
    int nb_out = (ct.delta_nb_bits[s] + (1 << 15)) >> 16;
    int32_t v = (nb_out << 16) - ct.delta_nb_bits[s];
    value = ct.state_table[(v >> nb_out) + ct.delta_find_state[s]];
  }
  inline void encode(const FseCT& ct, BW& bw, uint8_t s) {
    int nb_out = (value + ct.delta_nb_bits[s]) >> 16;
    bw.add((uint32_t)value, nb_out);
    value = ct.state_table[(value >> nb_out) + ct.delta_find_state[s]];
  }
  inline void flush(const FseCT& ct, BW& bw) {
    bw.add((uint32_t)value, ct.table_log);
  }
};

inline void fse_compress_using_ctable(const uint8_t* src, size_t n,
                                      const FseCT& ct,
                                      std::vector<uint8_t>& out) {
  if (n <= 2) return;
  BW bw;
  size_t ip = n;
  FseCState c1, c2;
  if (n & 1) {
    c1.init(ct, src[ip - 1]);
    c2.init(ct, src[ip - 2]);
    ip -= 2;
    c1.encode(ct, bw, src[ip - 1]);
    ip -= 1;
  } else {
    c2.init(ct, src[ip - 1]);
    c1.init(ct, src[ip - 2]);
    ip -= 2;
  }
  if ((n - 2) & 2) {
    c2.encode(ct, bw, src[ip - 1]);
    c1.encode(ct, bw, src[ip - 2]);
    ip -= 2;
  }
  while (ip > 0) {
    c2.encode(ct, bw, src[ip - 1]);
    c1.encode(ct, bw, src[ip - 2]);
    c2.encode(ct, bw, src[ip - 3]);
    c1.encode(ct, bw, src[ip - 4]);
    ip -= 4;
  }
  c2.flush(ct, bw);
  c1.flush(ct, bw);
  bw.close();
  out = std::move(bw.buf);
}

// HUF_compressWeights: 0 -> not compressible, 1 -> rle, 2 -> out has bytes
inline int huf_compress_weights(const uint8_t* weights, size_t wt_size,
                                std::vector<uint8_t>& out) {
  if (wt_size <= 1) return 0;
  uint32_t count[kHufTableLogMax + 1] = {0};
  int max_sym = kHufTableLogMax;
  for (size_t i = 0; i < wt_size; ++i) count[weights[i]]++;
  while (max_sym && !count[max_sym]) max_sym--;
  uint32_t max_count = 0;
  for (int s = 0; s <= max_sym; ++s)
    if (count[s] > max_count) max_count = count[s];
  if (max_count == wt_size) return 1;
  if (max_count == 1) return 0;
  int table_log = fse_optimal_table_log(6, wt_size, max_sym, 2);
  int16_t norm[kHufTableLogMax + 2];
  if (!fse_normalize_count(table_log, count, wt_size, max_sym, norm))
    return 1;
  std::vector<uint8_t> header;
  if (!fse_write_ncount(norm, max_sym, table_log, header)) return 0;
  FseCT ct;
  if (!fse_build_ctable(norm, max_sym, table_log, ct)) return 0;
  std::vector<uint8_t> body;
  fse_compress_using_ctable(weights, wt_size, ct, body);
  if (body.empty()) return 0;
  out = std::move(header);
  out.insert(out.end(), body.begin(), body.end());
  return 2;
}

// HUF_sort: rank-bucketed insertion sort, descending count
inline void huf_sort(const uint32_t* count, int max_sym, uint32_t* node_count,
                     uint8_t* node_byte) {
  uint32_t rank_base[32] = {0};
  for (int n = 0; n <= max_sym; ++n)
    rank_base[highbit32(count[n] + 1)]++;
  for (int n = 30; n > 0; --n) rank_base[n - 1] += rank_base[n];
  uint32_t rank_cur[32];
  std::memcpy(rank_cur, rank_base, sizeof(rank_base));
  for (int n = 0; n <= max_sym; ++n) {
    uint32_t c = count[n];
    int r = highbit32(c + 1) + 1;
    uint32_t pos = rank_cur[r]++;
    while (pos > rank_base[r] && c > node_count[pos - 1]) {
      node_count[pos] = node_count[pos - 1];
      node_byte[pos] = node_byte[pos - 1];
      pos--;
    }
    node_count[pos] = c;
    node_byte[pos] = (uint8_t)n;
  }
}

// HUF_setMaxHeight
inline int huf_set_max_height(uint8_t* nb_bits, const uint32_t* counts,
                              int last_non_null, int max_nb_bits) {
  int largest_bits = nb_bits[last_non_null];
  if (largest_bits <= max_nb_bits) return largest_bits;

  int64_t total_cost = 0;
  int base_cost = 1 << (largest_bits - max_nb_bits);
  int n = last_non_null;
  while (nb_bits[n] > max_nb_bits) {
    total_cost += base_cost - (1 << (largest_bits - nb_bits[n]));
    nb_bits[n] = (uint8_t)max_nb_bits;
    n--;
  }
  while (nb_bits[n] == max_nb_bits) n--;

  total_cost >>= (largest_bits - max_nb_bits);

  constexpr uint32_t kNoSymbol = 0xF0F0F0F0;
  uint32_t rank_last[kHufTableLogMax + 2];
  for (int i = 0; i < kHufTableLogMax + 2; ++i) rank_last[i] = kNoSymbol;
  int current_nb_bits = max_nb_bits;
  for (int pos = n; pos >= 0; --pos) {
    if (nb_bits[pos] >= current_nb_bits) continue;
    current_nb_bits = nb_bits[pos];
    rank_last[max_nb_bits - current_nb_bits] = (uint32_t)pos;
  }

  while (total_cost > 0) {
    int n_bits_to_decrease = highbit32((uint32_t)total_cost) + 1;
    while (n_bits_to_decrease > 1) {
      uint32_t high_pos = rank_last[n_bits_to_decrease];
      uint32_t low_pos = rank_last[n_bits_to_decrease - 1];
      if (high_pos == kNoSymbol) {
        n_bits_to_decrease--;
        continue;
      }
      if (low_pos == kNoSymbol) break;
      if (counts[high_pos] <= 2 * counts[low_pos]) break;
      n_bits_to_decrease--;
    }
    while (n_bits_to_decrease <= kHufTableLogMax &&
           rank_last[n_bits_to_decrease] == kNoSymbol)
      n_bits_to_decrease++;
    total_cost -= 1ll << (n_bits_to_decrease - 1);
    if (rank_last[n_bits_to_decrease - 1] == kNoSymbol)
      rank_last[n_bits_to_decrease - 1] = rank_last[n_bits_to_decrease];
    nb_bits[rank_last[n_bits_to_decrease]]++;
    if (rank_last[n_bits_to_decrease] == 0) {
      rank_last[n_bits_to_decrease] = kNoSymbol;
    } else {
      rank_last[n_bits_to_decrease]--;
      if (nb_bits[rank_last[n_bits_to_decrease]] !=
          max_nb_bits - n_bits_to_decrease)
        rank_last[n_bits_to_decrease] = kNoSymbol;
    }
  }

  while (total_cost < 0) {
    if (rank_last[1] == kNoSymbol) {
      while (nb_bits[n] == max_nb_bits) n--;
      nb_bits[n + 1]--;
      rank_last[1] = (uint32_t)(n + 1);
      total_cost++;
      continue;
    }
    nb_bits[rank_last[1] + 1]--;
    rank_last[1]++;
    total_cost++;
  }
  return max_nb_bits;
}

// HUF_buildCTable: fills sym_nb_bits/sym_val (size max_sym+1); returns
// huff_log or 0 on failure
inline int huf_build_ctable(const uint32_t* count, int max_sym,
                            int max_nb_bits, uint8_t* sym_nb_bits,
                            uint16_t* sym_val) {
  uint32_t node_count[256];
  uint8_t node_byte[256];
  huf_sort(count, max_sym, node_count, node_byte);

  int non_null_rank = max_sym;
  while (node_count[non_null_rank] == 0) non_null_rank--;

  int n_internal = non_null_rank;  // number of internal nodes
  if (n_internal == 0) {
    // single symbol: caller treats as RLE before reaching here
    return 0;
  }
  uint32_t icounts[256];
  int iparents[256];
  int leaf_parent[256];
  int low_s = non_null_rank;
  int node_nb = 0;
  icounts[0] = node_count[low_s] + node_count[low_s - 1];
  leaf_parent[low_s] = leaf_parent[low_s - 1] = 0;
  node_nb = 1;
  low_s -= 2;
  int low_n = 0;
  constexpr uint64_t kBig = 1ull << 30;

  auto leaf_count = [&](int i) -> uint64_t {
    return i >= 0 ? (uint64_t)node_count[i] : (1ull << 31);
  };
  auto icount = [&](int i) -> uint64_t {
    return i < node_nb ? (uint64_t)icounts[i] : kBig;
  };

  while (node_nb < n_internal) {
    int kind1, idx1, kind2, idx2;
    if (leaf_count(low_s) < icount(low_n)) {
      kind1 = 0;
      idx1 = low_s--;
    } else {
      kind1 = 1;
      idx1 = low_n++;
    }
    if (leaf_count(low_s) < icount(low_n)) {
      kind2 = 0;
      idx2 = low_s--;
    } else {
      kind2 = 1;
      idx2 = low_n++;
    }
    icounts[node_nb] =
        (uint32_t)((kind1 ? icounts[idx1] : leaf_count(idx1)) +
                   (kind2 ? icounts[idx2] : leaf_count(idx2)));
    if (kind1) iparents[idx1] = node_nb; else leaf_parent[idx1] = node_nb;
    if (kind2) iparents[idx2] = node_nb; else leaf_parent[idx2] = node_nb;
    node_nb++;
  }

  int root = n_internal - 1;
  uint8_t inb[256];
  inb[root] = 0;
  for (int i = root - 1; i >= 0; --i) inb[i] = inb[iparents[i]] + 1;
  uint8_t nb_bits[256] = {0};
  for (int i = 0; i <= non_null_rank; ++i)
    nb_bits[i] = inb[leaf_parent[i]] + 1;

  max_nb_bits = huf_set_max_height(nb_bits, node_count, non_null_rank,
                                   max_nb_bits);
  if (max_nb_bits > kHufTableLogMax) return 0;

  uint16_t nb_per_rank[kHufTableLogMax + 1] = {0};
  for (int i = 0; i <= non_null_rank; ++i) nb_per_rank[nb_bits[i]]++;
  uint16_t val_per_rank[kHufTableLogMax + 1] = {0};
  {
    uint32_t minv = 0;
    for (int b = max_nb_bits; b > 0; --b) {
      val_per_rank[b] = (uint16_t)minv;
      minv += nb_per_rank[b];
      minv >>= 1;
    }
  }
  for (int i = 0; i <= max_sym; ++i) sym_nb_bits[node_byte[i]] = nb_bits[i];
  for (int s = 0; s <= max_sym; ++s)
    sym_val[s] = val_per_rank[sym_nb_bits[s]]++;
  return max_nb_bits;
}

// HUF_writeCTable
inline bool huf_write_ctable(const uint8_t* sym_nb_bits, int max_sym,
                             int huff_log, std::vector<uint8_t>& out) {
  uint8_t bits_to_weight[kHufTableLogMax + 1] = {0};
  for (int n = 1; n <= huff_log; ++n)
    bits_to_weight[n] = (uint8_t)(huff_log + 1 - n);
  uint8_t weights[256];
  for (int n = 0; n < max_sym; ++n)
    weights[n] = bits_to_weight[sym_nb_bits[n]];

  std::vector<uint8_t> comp;
  int r = huf_compress_weights(weights, (size_t)max_sym, comp);
  if (r == 2 && comp.size() > 1 && comp.size() < (size_t)max_sym / 2) {
    out.push_back((uint8_t)comp.size());
    out.insert(out.end(), comp.begin(), comp.end());
    return true;
  }
  if (max_sym > 128) return false;
  out.push_back((uint8_t)(128 + (max_sym - 1)));
  uint8_t w[257];
  std::memcpy(w, weights, max_sym);
  w[max_sym] = 0;
  for (int n = 0; n < max_sym; n += 2)
    out.push_back((uint8_t)((w[n] << 4) + w[n + 1]));
  return true;
}

inline void huf_encode_1x(const uint8_t* src, size_t len,
                          const uint16_t* sym_val, const uint8_t* sym_nb_bits,
                          std::vector<uint8_t>& out) {
  BW bw;
  bw.buf.resize(len * 11 / 8 + 64);   // max 11 bits/symbol + slack
  size_t n = len & ~(size_t)3;
  size_t rem = len & 3;
  if (rem >= 3) bw.add_fast(sym_val[src[n + 2]], sym_nb_bits[src[n + 2]]);
  if (rem >= 2) bw.add_fast(sym_val[src[n + 1]], sym_nb_bits[src[n + 1]]);
  if (rem >= 1) bw.add_fast(sym_val[src[n]], sym_nb_bits[src[n]]);
  if (rem) bw.flush_unchecked();
  while (n > 0) {
    bw.add_fast(sym_val[src[n - 1]], sym_nb_bits[src[n - 1]]);
    bw.add_fast(sym_val[src[n - 2]], sym_nb_bits[src[n - 2]]);
    bw.add_fast(sym_val[src[n - 3]], sym_nb_bits[src[n - 3]]);
    bw.add_fast(sym_val[src[n - 4]], sym_nb_bits[src[n - 4]]);
    bw.flush_unchecked();
    n -= 4;
  }
  bw.close();
  out = std::move(bw.buf);
}

// HUF_compress (4-stream). Returns true and fills out; false = caller
// should store the stream raw.
inline bool huf_compress(const uint8_t* src, size_t n,
                         std::vector<uint8_t>& out) {
  if (n == 0 || n > 128 * 1024 || n < 12) return false;
  uint32_t count[256] = {0};
  for (size_t i = 0; i < n; ++i) count[src[i]]++;
  int max_sym = 255;
  while (max_sym && !count[max_sym]) max_sym--;
  uint32_t largest = 0;
  for (int s = 0; s <= max_sym; ++s)
    if (count[s] > largest) largest = count[s];
  if (largest == n) {
    out.assign(1, src[0]);  // rle
    return true;
  }
  if (largest <= (n >> 7) + 1) return false;

  int huff_log = fse_optimal_table_log(kHufTableLogDefault, n, max_sym, 1);
  uint8_t sym_nb_bits[256] = {0};
  uint16_t sym_val[256] = {0};
  huff_log = huf_build_ctable(count, max_sym, huff_log, sym_nb_bits, sym_val);
  if (huff_log == 0) return false;
  std::vector<uint8_t> header;
  if (!huf_write_ctable(sym_nb_bits, max_sym, huff_log, header)) return false;
  if (header.size() + 12 >= n) return false;

  size_t seg = (n + 3) / 4;
  std::vector<uint8_t> parts[4];
  for (int i = 0; i < 4; ++i) {
    size_t a = (size_t)i * seg;
    size_t b = i < 3 ? a + seg : n;
    huf_encode_1x(src + a, b - a, sym_val, sym_nb_bits, parts[i]);
    if (parts[i].empty() || parts[i].size() > 0xFFFF) return false;
  }
  out = std::move(header);
  for (int i = 0; i < 3; ++i) {
    out.push_back((uint8_t)parts[i].size());
    out.push_back((uint8_t)(parts[i].size() >> 8));
  }
  for (int i = 0; i < 4; ++i)
    out.insert(out.end(), parts[i].begin(), parts[i].end());
  if (out.size() >= n - 1) return false;
  return true;
}

}  // namespace hufenc

// ===========================================================================
// LIZv1-family block-stream ENCODER + all-level dispatch. Greedy hash match
// finder with rep-offset awareness emitting the LIZv1 codeword scheme
// (written against the format pinned by lizard_tpu/ref/block_encode.py
// encode_seq_liz, i.e. lib/lizard_compress_liz.h:43-165 semantics):
//   token < 31     : long-offset match, ml = token + 16, offset from off24
//   token == 31    : long-offset match, ml = 47 + ext, offset from off24
//   token >= 32    : ll = token&7 (7 = +ext), ml = (token>>3)&15 (15 = +ext),
//                    bit7 set -> rep offset (reuse last), else off16
// Length extensions ride the literals stream. Levels >= 30 additionally gate
// the flags/literals streams through the Huff0 encoder above
// (Lizard_writeStream, lizard_compress.c:141-183).
// ===========================================================================
namespace {

constexpr uint32_t kMaxOff24 = (1u << 24) - 1;
constexpr uint32_t kMmLongOff = 16;  // min match length for offsets >= 1<<16

struct LizAcc {
  std::vector<uint8_t> flags, lits, off16, off24;
  uint32_t last_off = 0;
};

inline void emit_seq_liz(const uint8_t* src, size_t anchor, size_t ip,
                         size_t mlen, uint32_t off, LizAcc& a) {
  size_t ll = ip - anchor;
  size_t tok = a.flags.size();
  a.flags.push_back(0);

  if (ll > 0 || off < 65536) {
    if (ll >= 7) {
      a.flags[tok] = 7;
      put_ext(a.lits, (uint32_t)(ll - 7));
    } else {
      a.flags[tok] = (uint8_t)ll;
    }
    a.lits.insert(a.lits.end(), src + anchor, src + ip);
    if (off >= 65536) {
      // literals carried by a zero-length rep token, then the long token
      a.flags[tok] += 128;
      tok = a.flags.size();
      a.flags.push_back(0);
    }
  }

  if (off >= 65536) {
    if (mlen - kMmLongOff >= 31) {
      a.flags[tok] = 31;
      put_ext(a.lits, (uint32_t)(mlen - kMmLongOff - 31));
    } else {
      a.flags[tok] = (uint8_t)(mlen - kMmLongOff);
    }
    put_le24(a.off24, off);
    a.last_off = off;
  } else {
    if (off == 0) {
      a.flags[tok] += 128;  // rep: reuse last_off
    } else {
      a.last_off = off;
      a.off16.push_back((uint8_t)off);
      a.off16.push_back((uint8_t)(off >> 8));
    }
    if (mlen >= 15) {
      a.flags[tok] += 15 << 3;
      put_ext(a.lits, (uint32_t)(mlen - 15));
    } else {
      a.flags[tok] += (uint8_t)(mlen << 3);
    }
  }
}

inline size_t match_fwd(const uint8_t* src, size_t a, size_t b, size_t lim) {
  size_t l = 0;
  while (b + l + 8 <= lim) {
    uint64_t x = rd64(src + a + l) ^ rd64(src + b + l);
    if (x) return l + (__builtin_ctzll(x) >> 3);
    l += 8;
  }
  while (b + l < lim && src[a + l] == src[b + l]) ++l;
  return l;
}

// encode src[b0, b1) as one inner block's LIZv1 streams; window shared
// across inner blocks of the same stream (hash positions absolute in src)
void encode_inner_liz(const uint8_t* src, size_t b0, size_t b1, size_t n,
                      uint32_t* htab, int hlog, int accel, LizAcc& a) {
  a.flags.clear();
  a.lits.clear();
  a.off16.clear();
  a.off24.clear();
  a.last_off = 0;  // the decoder resets last_off at each inner block
  size_t ip = b0, anchor = b0;
  size_t mflimit = (b1 >= 20 && b1 - 20 >= b0) ? b1 - 20 : b0;
  size_t copy_lim = b1 - (b1 - b0 > kLastLiterals ? kLastLiterals : 0);

  if (b1 - b0 > 24) {
    uint32_t searches = 0;
    while (ip < mflimit) {
      size_t best_len = 0;
      uint32_t best_off = 0;  // 0 encodes rep
      // rep-offset probe: free to encode (no offset bytes)
      if (a.last_off && ip >= a.last_off) {
        size_t l = match_fwd(src, ip - a.last_off, ip, copy_lim);
        if (l >= 2) {
          best_len = l;
          best_off = 0;
        }
      }
      uint32_t v = rd32(src + ip);
      uint32_t h = ehash(v, hlog);
      size_t cand = htab[h];
      htab[h] = (uint32_t)ip;
      if (cand < ip && cand + 8 <= ip && ip - cand <= kMaxOff24 &&
          rd32(src + cand) == v) {
        uint32_t off = (uint32_t)(ip - cand);
        size_t l = 4 + match_fwd(src, cand + 4, ip + 4, copy_lim);
        // long offsets must clear MM_LONGOFF and pay 3 offset bytes;
        // short new offsets pay 2, a rep none -- margin biases the pick
        bool usable = off < 65536 || l >= kMmLongOff;
        size_t margin =
            off >= 65536 ? 3 : (best_off == 0 && best_len ? 1 : 0);
        if (usable && l > best_len + margin) {
          best_len = l;
          best_off = off;
        }
      }
      if ((best_len >= 4 && best_off != 0) ||
          (best_len >= 2 && best_off == 0)) {
        size_t mq = ip;
        // backward extension (offset preserved; source may reach into
        // earlier inner blocks -- the window is the whole stream)
        uint32_t eff_off = best_off ? best_off : a.last_off;
        while (mq > anchor && mq >= (size_t)eff_off + 1 &&
               src[mq - 1] == src[mq - 1 - eff_off]) {
          --mq;
          ++best_len;
        }
        emit_seq_liz(src, anchor, mq, best_len, best_off, a);
        anchor = mq + best_len;
        ip = anchor;
        searches = 0;
        if (ip - 2 > b0 && ip < mflimit)
          htab[ehash(rd32(src + ip - 2), hlog)] = (uint32_t)(ip - 2);
        continue;
      }
      ip += 1 + (searches++ >> (6 + (accel > 1 ? accel - 1 : 0)));
    }
  }
  a.lits.insert(a.lits.end(), src + anchor, src + b1);
}

// Lizard_writeStream: append one stream, optionally Huff0-gated. Returns
// the header-flag multiplier (1 when Huffman was kept).
inline int write_stream_n(std::vector<uint8_t>& out,
                          const std::vector<uint8_t>& s, bool use_huff) {
  if (use_huff && s.size() > 1024) {
    std::vector<uint8_t> comp;
    if (hufenc::huf_compress(s.data(), s.size(), comp) && !comp.empty() &&
        comp.size() + comp.size() / 8 + 512 < s.size()) {
      put_le24(out, (uint32_t)s.size());
      put_le24(out, (uint32_t)comp.size());
      out.insert(out.end(), comp.begin(), comp.end());
      return 1;
    }
  }
  put_le24(out, (uint32_t)s.size());
  out.insert(out.end(), s.begin(), s.end());
  return 0;
}

// Lizard_writeBlock: serialize one inner block (stream order lens, off16,
// off24, flags, literals; stored-block fallbacks, lizard_compress.c:186-250)
inline void write_block_n(std::vector<uint8_t>& out, const uint8_t* src,
                          size_t b0, size_t raw,
                          const std::vector<uint8_t>& flags,
                          const std::vector<uint8_t>& lits,
                          const std::vector<uint8_t>& off16,
                          const std::vector<uint8_t>& off24, bool huff) {
  static const std::vector<uint8_t> kEmpty;
  size_t sum_len =
      flags.size() + lits.size() + off16.size() + off24.size();

  auto write_uncompressed = [&]() {
    out.push_back(kFlagUncompressed);
    put_le24(out, (uint32_t)raw);
    out.insert(out.end(), src + b0, src + b0 + raw);
  };

  if (lits.size() < 16 || sum_len + 5 * 3 + 1 > raw) {
    write_uncompressed();
    return;
  }
  size_t header_pos = out.size();
  out.push_back(0);
  write_stream_n(out, kEmpty, false);                       // lens
  out[header_pos] += write_stream_n(out, off16, false) * 4;
  out[header_pos] += write_stream_n(out, off24, false) * 8;
  out[header_pos] += write_stream_n(out, flags, huff) * 2;
  out[header_pos] += write_stream_n(out, lits, huff) * 1;

  size_t comp = out.size() - header_pos;
  if (comp + comp / 32 + 512 > raw) {
    out.resize(header_pos);
    write_uncompressed();
  }
}


// ---------------------------------------------------------------------
// Faithful C++ port of this repo's own bit-exact parser oracle
// (lizard_tpu/ref/parsers.py, itself written against the reference's
// lib/lizard_parser_{nochain,hashchain,fastbig,pricefast,lowestprice}.h
// decisions): same candidate order, same tie-breaks, same lazy-overlap
// arbitration, so the PARSE equals the reference parse and the ratios
// match the reference per level. The emitted streams still go through
// this file's emit helpers (valid streams; byte-identity is the Python
// oracle's job).

namespace refparse {

constexpr uint64_t kDict = 1ull << 24;   // LIZARD_DICT_SIZE index offset
constexpr int64_t kMinMatch = 4;
constexpr int64_t kMfLimit = 20;         // WILDCOPYLENGTH + MINMATCH
constexpr int64_t kLastLit = 16;
constexpr int64_t kOptimalMl = 18;       // 15 - 1 + MINMATCH
constexpr uint32_t kMax16 = 1u << 16;
constexpr uint64_t kMaxPrice = 1ull << 28;
constexpr int kSkipTrigger = 6;

inline uint32_t h4(uint32_t v, int h) {
  return (uint32_t)(((uint64_t)v * 2654435761u & 0xFFFFFFFFu) >> (32 - h));
}
inline uint32_t h5(uint64_t v, int h) {
  return (uint32_t)((v * 889523592379ull << 24) >> (64 - h));
}
inline uint32_t h6(uint64_t v, int h) {
  return (uint32_t)((v * 227718039650203ull << 16) >> (64 - h));
}

struct PCtx {
  std::vector<uint32_t> hash;    // head = position + kDict; 0 = empty
  std::vector<uint32_t> chain;   // delta ring, 1<<content_log entries
  uint64_t next_to_update = kDict;
  int hash_log = 0, content_log = 0, window_log = 0;
  int search_num = 0, search_length = 4;
  int64_t mm_long = 0, sufficient = 0;
  bool huff = false;             // price-penalty constants (levels >= 30)
  const uint8_t* src = nullptr;
  int64_t n = 0;

  inline uint32_t hpos(int64_t i) const {
    if (search_length == 5) return h5(rd64(src + i), hash_log);
    if (search_length == 6) return h6(rd64(src + i), hash_log);
    return h4(rd32(src + i), hash_log);
  }
  inline int64_t low_limit(int64_t pos) const {
    uint64_t maxd = (1ull << window_log) - 1;
    uint64_t cur = (uint64_t)pos + kDict;
    return (kDict + maxd >= cur) ? (int64_t)kDict : (int64_t)(cur - maxd);
  }
  void insert(int64_t target_pos) {
    uint64_t target = (uint64_t)target_pos + kDict;
    uint32_t mask = (1u << content_log) - 1;
    uint64_t maxd = (1ull << window_log) - 1;
    while (next_to_update < target) {
      uint64_t idx = next_to_update;
      uint32_t h = hpos((int64_t)(idx - kDict));
      uint64_t delta = idx - hash[h];
      if (delta > maxd) delta = maxd;
      chain[idx & mask] = (uint32_t)delta;
      if (hash[h] >= idx || idx >= (uint64_t)hash[h] + 8)
        hash[h] = (uint32_t)idx;
      ++next_to_update;
    }
  }
};

// Lizard_count: equal run of src[i..] vs src[j..], j capped at limit
inline int64_t count_eq(const uint8_t* src, int64_t i, int64_t j,
                        int64_t limit) {
  return (int64_t)match_fwd(src, (size_t)i, (size_t)j, (size_t)limit);
}

// ---- hashChain search (lizard_parser_hashchain.h:45-185) ----

inline int64_t find_best_hc(PCtx& c, int64_t ip, int64_t ilimit,
                            int64_t& ref) {
  c.insert(ip);
  uint32_t mask = (1u << c.content_log) - 1;
  int64_t low = c.low_limit(ip);
  uint64_t cur = (uint64_t)ip + kDict;
  uint64_t mi = c.hash[c.hpos(ip)];
  int attempts = c.search_num;
  int64_t ml = 0;
  ref = -1;
  uint32_t v = rd32(c.src + ip);
  while (mi < cur && mi >= (uint64_t)low && attempts) {
    --attempts;
    int64_t m = (int64_t)(mi - kDict);
    if (ip - m >= 8 && c.src[m + ml] == c.src[ip + ml] &&
        rd32(c.src + m) == v) {
      int64_t mlt =
          count_eq(c.src, m + kMinMatch, ip + kMinMatch, ilimit) + kMinMatch;
      if (mlt > ml) {
        ml = mlt;
        ref = m;
      }
    }
    uint32_t delta = c.chain[mi & mask];
    if ((uint64_t)delta > mi) break;
    mi -= delta;
  }
  return ml;
}

inline int64_t wider_hc(PCtx& c, int64_t ip, int64_t ilow, int64_t ihigh,
                        int64_t longest, int64_t& ref, int64_t& start) {
  c.insert(ip);
  uint32_t mask = (1u << c.content_log) - 1;
  int64_t low = c.low_limit(ip);
  uint64_t cur = (uint64_t)ip + kDict;
  int64_t ll_delta = ip - ilow;
  uint64_t mi = c.hash[c.hpos(ip)];
  int attempts = c.search_num;
  ref = -1;
  start = -1;
  uint32_t v = rd32(c.src + ip);
  while (mi < cur && mi >= (uint64_t)low && attempts) {
    --attempts;
    int64_t m = (int64_t)(mi - kDict);
    if (ip - m >= 8 &&
        c.src[ilow + longest] == c.src[m - ll_delta + longest] &&
        rd32(c.src + m) == v) {
      int64_t mlt =
          kMinMatch + count_eq(c.src, m + kMinMatch, ip + kMinMatch, ihigh);
      int64_t back = 0;
      while (ip + back > ilow && m + back > 0 &&
             c.src[ip + back - 1] == c.src[m + back - 1])
        --back;
      mlt -= back;
      if (mlt > longest) {
        longest = mlt;
        ref = m + back;
        start = ip + back;
      }
    }
    uint32_t delta = c.chain[mi & mask];
    if ((uint64_t)delta > mi) break;
    mi -= delta;
  }
  return longest;
}

// ---- noChain search (lizard_parser_nochain.h) ----

inline void insert_nc(PCtx& c, int64_t target_pos) {
  uint64_t target = (uint64_t)target_pos + kDict;
  while (c.next_to_update < target) {
    uint64_t idx = c.next_to_update;
    uint32_t h = h5(rd64(c.src + (int64_t)(idx - kDict)), c.hash_log);
    if (c.hash[h] >= idx || idx >= (uint64_t)c.hash[h] + 8)
      c.hash[h] = (uint32_t)idx;
    ++c.next_to_update;
  }
}

inline int64_t find_best_nc(PCtx& c, int64_t ip, int64_t ilimit,
                            int64_t& ref) {
  insert_nc(c, ip);
  int64_t low = c.low_limit(ip);
  uint64_t cur = (uint64_t)ip + kDict;
  uint64_t mi = c.hash[h5(rd64(c.src + ip), c.hash_log)];
  ref = -1;
  if (mi < cur && mi >= (uint64_t)low) {
    int64_t m = (int64_t)(mi - kDict);
    if (ip - m >= 8 && c.src[m] == c.src[ip] &&
        rd32(c.src + m) == rd32(c.src + ip)) {
      ref = m;
      return count_eq(c.src, m + kMinMatch, ip + kMinMatch, ilimit) +
             kMinMatch;
    }
  }
  return 0;
}

inline int64_t wider_nc(PCtx& c, int64_t ip, int64_t ilow, int64_t ihigh,
                        int64_t longest, int64_t& ref, int64_t& start) {
  insert_nc(c, ip);
  int64_t low = c.low_limit(ip);
  uint64_t cur = (uint64_t)ip + kDict;
  int64_t ll_delta = ip - ilow;
  uint64_t mi = c.hash[h5(rd64(c.src + ip), c.hash_log)];
  ref = -1;
  start = -1;
  if (mi < cur && mi >= (uint64_t)low) {
    int64_t m = (int64_t)(mi - kDict);
    if (ip - m >= 8 &&
        c.src[ilow + longest] == c.src[m - ll_delta + longest] &&
        rd32(c.src + m) == rd32(c.src + ip)) {
      int64_t mlt =
          kMinMatch + count_eq(c.src, m + kMinMatch, ip + kMinMatch, ihigh);
      int64_t back = 0;
      while (ip + back > ilow && m + back > 0 &&
             c.src[ip + back - 1] == c.src[m + back - 1])
        --back;
      mlt -= back;
      if (mlt > longest) {
        longest = mlt;
        ref = m + back;
        start = ip + back;
      }
    }
  }
  return longest;
}

// ---- shared LZ4 lazy-overlap driver (ref/parsers.py _parse_lazy_lz4,
// i.e. lizard_parser_nochain.h:143-318 / _hashchain.h:188-369) ----

template <typename FindBest, typename GetWider>
void parse_lazy_lz4(PCtx& c, int64_t start_pos, int64_t end, EncAcc& acc,
                    FindBest find_best, GetWider get_wider,
                    bool hc_fit_check, int64_t* anchor_io) {
  const uint8_t* src = c.src;
  int64_t anchor = *anchor_io;
  int64_t mflimit = end - kMfLimit;
  int64_t matchlimit = end - kLastLit;
  int64_t ip = start_pos + 1;

  auto emit = [&](int64_t& at, int64_t ml, int64_t ref) {
    int64_t ll = at - anchor;
    uint32_t off = (uint32_t)(at - ref);
    uint32_t mlx = (uint32_t)ml - 4;
    acc.flags.push_back((uint8_t)(((mlx < 15 ? mlx : 15) << 4) |
                                  (ll < 15 ? (uint8_t)ll : 15)));
    if (ll >= 15) put_ext(acc.lits, (uint32_t)(ll - 15));
    acc.lits.insert(acc.lits.end(), src + anchor, src + anchor + ll);
    acc.lits.push_back((uint8_t)off);
    acc.lits.push_back((uint8_t)(off >> 8));
    if (mlx >= 15) put_ext(acc.lits, mlx - 15);
    at += ml;
    anchor = at;
  };

  while (ip < mflimit) {
    int64_t ref;
    int64_t ml = find_best(c, ip, matchlimit, ref);
    if (!ml) {
      ++ip;
      continue;
    }
    int64_t start0 = ip, ref0 = ref, ml0 = ml;
    int64_t ml2 = 0, ref2 = -1, start2 = -1;
    int64_t ml3 = 0, ref3 = -1, start3 = -1;

  _search2:
    if (ip + ml < mflimit)
      ml2 = get_wider(c, ip + ml - 2, ip + 1, matchlimit, ml, ref2, start2);
    else
      ml2 = ml;
    if (ml2 == ml) {
      emit(ip, ml, ref);
      continue;
    }
    if (start0 < ip && start2 < ip + ml0) {
      ip = start0;
      ref = ref0;
      ml = ml0;
    }
    if (start2 - ip < 3) {
      ml = ml2;
      ip = start2;
      ref = ref2;
      goto _search2;
    }

  _search3:
    if (start2 - ip < kOptimalMl) {
      int64_t new_ml = ml < kOptimalMl ? ml : kOptimalMl;
      if (ip + new_ml > start2 + ml2 - kMinMatch) {
        new_ml = (start2 - ip) + ml2 - kMinMatch;
        if (hc_fit_check && new_ml < kMinMatch) {
          emit(ip, ml, ref);
          continue;
        }
      }
      int64_t correction = new_ml - (start2 - ip);
      if (correction > 0) {
        start2 += correction;
        ref2 += correction;
        ml2 -= correction;
      }
    }
    if (start2 + ml2 < mflimit)
      ml3 = get_wider(c, start2 + ml2 - 3, start2, matchlimit, ml2, ref3,
                      start3);
    else
      ml3 = ml2;
    if (ml3 == ml2) {
      if (start2 < ip + ml) ml = start2 - ip;
      emit(ip, ml, ref);
      ip = start2;
      emit(ip, ml2, ref2);
      continue;
    }
    if (start3 < ip + ml + 3) {
      if (start3 >= ip + ml) {
        if (start2 < ip + ml) {
          int64_t correction = ip + ml - start2;
          start2 += correction;
          ref2 += correction;
          ml2 -= correction;
          if (ml2 < kMinMatch) {
            start2 = start3;
            ref2 = ref3;
            ml2 = ml3;
          }
        }
        emit(ip, ml, ref);
        ip = start3;
        ref = ref3;
        ml = ml3;
        start0 = start2;
        ref0 = ref2;
        ml0 = ml2;
        goto _search2;
      }
      start2 = start3;
      ref2 = ref3;
      ml2 = ml3;
      goto _search3;
    }
    // 3 ascending matches
    if (start2 < ip + ml) {
      if (start2 - ip < 15) {
        if (ml > kOptimalMl) ml = kOptimalMl;
        if (ip + ml > start2 + ml2 - kMinMatch) {
          ml = (start2 - ip) + ml2 - kMinMatch;
          if (ml < kMinMatch) {
            emit(ip, ml, ref);
            ip = start3;
            ref = ref3;
            ml = ml3;
            start0 = start2;
            ref0 = ref2;
            ml0 = ml2;
            goto _search2;
          }
        }
        int64_t correction = ml - (start2 - ip);
        if (correction > 0) {
          start2 += correction;
          ref2 += correction;
          ml2 -= correction;
        }
      } else {
        ml = start2 - ip;
      }
    }
    emit(ip, ml, ref);
    ip = start2;
    ref = ref2;
    ml = ml2;
    start2 = start3;
    ref2 = ref3;
    ml2 = ml3;
    goto _search3;
  }
  *anchor_io = anchor;
}

// ---- LIZv1 price model (ref/price.py get_price_liz, simple/non-adaptive
// path -- the one lowestPrice always uses) ----

inline uint64_t ext_price(uint64_t length) {
  if (length >= 65536) return 32;
  if (length >= 254) return 24;
  return 8;
}

inline int highbit32(uint32_t v) { return v ? 31 - __builtin_clz(v) : -1; }

inline uint64_t price_liz(const PCtx& c, uint64_t lit_length, uint32_t offset,
                          int64_t match_length) {
  uint64_t price = 8 * lit_length;   // wraps mod 2^64 like size_t
  if (lit_length > 0 || offset < kMax16) {
    if (lit_length >= 7) price += ext_price(lit_length - 7);
    if (offset >= kMax16) price += 8;
  }
  if (offset >= kMax16) {
    if (match_length < c.mm_long) return kMaxPrice;
    if (match_length - c.mm_long >= 31)
      price += ext_price((uint64_t)(match_length - c.mm_long - 31));
    price += 24;
  } else {
    if (offset != 0) {
      if (offset < 8) return kMaxPrice;
      if (match_length < kMinMatch) return kMaxPrice;
      price += 16;
    }
    if (match_length >= 15) price += ext_price((uint64_t)(match_length - 15));
  }
  if (offset > 0 || match_length > 0) {
    int ol = highbit32(offset);
    if (c.huff) {
      price += (ol >= 20) ? (uint64_t)(ol - 19) * 4 : 0;
      price += 4 + (match_length == 1 ? 1 : 0);
    } else {
      price += (ol >= 16) ? (uint64_t)(ol - 15) * 4 : 0;
      price += 6 + (match_length == 1 ? 1 : 0);
    }
    price += 8;
  }
  return price;
}

// Lizard_better_price / Lizard_more_profitable
// (lizard_parser_lowestprice.h:4-26)
inline bool better_price(const PCtx& c, uint32_t best_off, int64_t best_common,
                         uint32_t off, int64_t common, uint32_t last_off) {
  if (off == last_off) off = 0;
  if (best_off == last_off) best_off = 0;
  return price_liz(c, 0, off, common) <
         price_liz(c, (uint64_t)(common - best_common), best_off, best_common);
}

inline bool more_profitable(const PCtx& c, uint32_t best_off,
                            int64_t best_common, uint32_t off, int64_t common,
                            int64_t literals, uint32_t last_off) {
  uint64_t lit = (uint64_t)literals;   // size_t wrap semantics
  uint64_t s;
  if ((int64_t)lit > 0)
    s = (uint64_t)std::max<int64_t>((int64_t)(common + (int64_t)lit),
                                    best_common);
  else
    s = (uint64_t)std::max<int64_t>(common, best_common);
  if (off == last_off) off = 0;
  if (best_off == last_off) best_off = 0;
  return price_liz(c, s - (uint64_t)common, off, common) <=
         price_liz(c, s - (uint64_t)best_common, best_off, best_common);
}

// ---- lowestPrice search (lizard_parser_lowestprice.h:29-251) ----

inline int64_t find_match_lp(PCtx& c, uint32_t last_off, int64_t ip,
                             int64_t ilimit, int64_t& ref, bool& is_rep) {
  uint32_t mask = (1u << c.content_log) - 1;
  int64_t low = c.low_limit(ip);
  uint64_t cur = (uint64_t)ip + kDict;
  uint64_t mi = c.hash[c.hpos(ip)];
  is_rep = false;
  ref = -1;

  if (last_off >= 8) {
    int64_t ilo = (int64_t)(cur - last_off);
    if (ilo >= low) {
      int64_t m = ilo - (int64_t)kDict;
      int64_t mlt = count_eq(c.src, m, ip, ilimit);
      if (mlt > 1) {   // REPMINMATCH
        ref = m;
        is_rep = true;
        return mlt;
      }
    }
  }
  int attempts = c.search_num;
  int64_t ml = 0;
  uint32_t v = rd32(c.src + ip);
  while (mi < cur && mi >= (uint64_t)low && attempts) {
    --attempts;
    int64_t m = (int64_t)(mi - kDict);
    if (ip - m >= 8 && c.src[m + ml] == c.src[ip + ml] &&
        rd32(c.src + m) == v) {
      int64_t mlt =
          count_eq(c.src, m + kMinMatch, ip + kMinMatch, ilimit) + kMinMatch;
      if (mlt >= c.mm_long || ip - m < (int64_t)kMax16) {
        if (!ml || (mlt > ml &&
                    better_price(c, (uint32_t)(ip - ref), ml,
                                 (uint32_t)(ip - m), mlt, last_off))) {
          ml = mlt;
          ref = m;
        }
      }
    }
    mi -= c.chain[mi & mask];
  }
  return ml;
}

inline int64_t wider_lp(PCtx& c, uint32_t last_off, int64_t ip, int64_t ilow,
                        int64_t ihigh, int64_t longest, int64_t& ref,
                        int64_t& start) {
  uint32_t mask = (1u << c.content_log) - 1;
  int64_t low = c.low_limit(ip);
  uint64_t cur = (uint64_t)ip + kDict;
  uint64_t mi = c.hash[c.hpos(ip)];
  ref = -1;
  start = -1;

  if (last_off >= 8) {
    int64_t ilo = (int64_t)(cur - last_off);
    if (ilo >= low) {
      int64_t m = ilo - (int64_t)kDict;
      if (rd32(c.src + m) == rd32(c.src + ip)) {
        int64_t back = 0;
        int64_t mlt =
            count_eq(c.src, m + kMinMatch, ip + kMinMatch, ihigh) + kMinMatch;
        while (ip + back > ilow && m + back > 0 &&
               c.src[ip + back - 1] == c.src[m + back - 1])
          --back;
        mlt -= back;
        if (mlt > longest &&
            (mlt >= c.mm_long || last_off < kMax16)) {
          longest = mlt;
          ref = m + back;
          start = ip + back;
        }
      }
    }
  }
  int attempts = c.search_num;
  uint32_t v = rd32(c.src + ip);
  while (mi < cur && mi >= (uint64_t)low && attempts) {
    --attempts;
    int64_t m = (int64_t)(mi - kDict);
    if (ip - m >= 8 && rd32(c.src + m) == v) {
      int64_t back = 0;
      int64_t mlt =
          count_eq(c.src, m + kMinMatch, ip + kMinMatch, ihigh) + kMinMatch;
      while (ip + back > ilow && m + back > 0 &&
             c.src[ip + back - 1] == c.src[m + back - 1])
        --back;
      mlt -= back;
      if (mlt >= c.mm_long || ip - m < (int64_t)kMax16) {
        if (!longest ||
            (mlt > longest &&
             better_price(c, (uint32_t)(start - ref), longest,
                          (uint32_t)(ip - m), mlt, last_off))) {
          longest = mlt;
          ref = m + back;
          start = ip + back;
        }
      }
    }
    mi -= c.chain[mi & mask];
  }
  return longest;
}

// ---- drivers ----

// lowestPrice (lizard_parser_lowestprice.h:256-375); LizAcc carries
// last_off across emits exactly like ctx->last_off
void parse_lowestprice(PCtx& c, int64_t start_pos, int64_t end, LizAcc& a) {
  const uint8_t* src = c.src;
  int64_t anchor = start_pos;
  int64_t mflimit = end - kMfLimit;
  int64_t matchlimit = end - kLastLit;
  int64_t ip = start_pos;

  auto emit = [&](int64_t& at, int64_t ml, int64_t ref) {
    uint32_t off = (at - ref == (int64_t)a.last_off) ? 0 : (uint32_t)(at - ref);
    emit_seq_liz(src, (size_t)anchor, (size_t)at, (size_t)ml, off, a);
    at += ml;
    anchor = at;
  };

  while (ip < mflimit) {
    c.insert(ip);
    bool is_rep;
    int64_t ref;
    int64_t ml = find_match_lp(c, a.last_off, ip, matchlimit, ref, is_rep);
    if (!ml) {
      ++ip;
      continue;
    }
    int64_t back = 0;
    while (ip + back > anchor && ref + back > 0 &&
           src[ip + back - 1] == src[ref + back - 1])
      --back;
    ml -= back;
    ip += back;
    ref += back;

    int64_t start0 = ip, ref0 = ref, ml0 = ml;

  _search:
    if (ip + ml < mflimit && ml < c.sufficient) {
      c.insert(ip);
      int64_t ml2, ref2, start2;
      ml2 = wider_lp(c, a.last_off, ip + ml - 2, anchor, matchlimit, 0, ref2,
                     start2);
      if (ml2) {
        // lowest-price split point (lizard_parser_lowestprice.h:304-342)
        int64_t best_pos = ip;
        uint64_t best_price = kMaxPrice;
        uint32_t off0 = (uint32_t)(ip - ref);
        uint32_t off1 = (uint32_t)(start2 - ref2);
        int64_t pos = ip + ml;
        while (pos >= start2) {
          int64_t common0 = pos - ip;
          if (common0 >= kMinMatch) {
            uint64_t price = price_liz(
                c, (uint64_t)(ip - anchor),
                off0 == a.last_off ? 0 : off0, common0);
            int64_t common1 = start2 + ml2 - pos;
            if (common1 >= kMinMatch)
              price += price_liz(c, 0, off1 == off0 ? 0 : off1, common1);
            else
              price += price_liz(c, (uint64_t)common1, 0, 0);
            if (price < best_price) {
              best_price = price;
              best_pos = pos;
            }
          } else {
            uint64_t price = price_liz(
                c, (uint64_t)(start2 - anchor),
                off1 == a.last_off ? 0 : off1, ml2);
            if (price < best_price) best_pos = pos;
            break;
          }
          --pos;
        }
        ml = best_pos - ip;
        if (ml < kMinMatch ||
            (ml < c.mm_long && ip - ref >= (int64_t)kMax16)) {
          ip = start2;
          ref = ref2;
          ml = ml2;
          goto _search;
        }
      }
    }
    // encode
    if (start0 < ip) {
      if (more_profitable(c, (uint32_t)(ip - ref), ml,
                          (uint32_t)(start0 - ref0), ml0, ref0 - ref,
                          a.last_off)) {
        ip = start0;
        ref = ref0;
        ml = ml0;
      }
    }
    emit(ip, ml, ref);
  }
  a.lits.insert(a.lits.end(), src + anchor, src + end);
}

// priceFast (lizard_parser_pricefast.h:132-249)
void parse_pricefast(PCtx& c, int64_t start_pos, int64_t end, LizAcc& a) {
  const uint8_t* src = c.src;
  int64_t anchor = start_pos;
  int64_t mflimit = end - kMfLimit;
  int64_t matchlimit = end - kLastLit;
  int64_t ip = start_pos + 1;

  auto head_update = [&](uint32_t h, int64_t pos) {
    uint64_t cur = (uint64_t)pos + kDict;
    if (c.hash[h] >= cur || cur >= (uint64_t)c.hash[h] + 8)
      c.hash[h] = (uint32_t)cur;
  };
  // Lizard_FindMatchFast: rep probe then single head candidate
  auto find_fast = [&](uint64_t head, int64_t at, int64_t& ref,
                       bool& is_rep) -> int64_t {
    uint64_t maxd = (1ull << c.window_log) - 1;
    uint64_t cur = (uint64_t)at + kDict;
    uint64_t low = (kDict + maxd >= cur) ? kDict : cur - maxd;
    is_rep = false;
    ref = -1;
    if (a.last_off >= 8) {
      uint64_t ilo = cur - a.last_off;
      if (ilo >= low) {
        int64_t m = (int64_t)(ilo - kDict);
        if (rd32(src + m) == rd32(src + at)) {
          ref = m;
          is_rep = true;
          return count_eq(src, m + kMinMatch, at + kMinMatch, matchlimit) +
                 kMinMatch;
        }
      }
    }
    if (head < cur && head >= low) {
      int64_t m = (int64_t)(head - kDict);
      if (at - m >= 8 && rd32(src + m) == rd32(src + at)) {
        int64_t mlt =
            count_eq(src, m + kMinMatch, at + kMinMatch, matchlimit) +
            kMinMatch;
        if (mlt >= c.mm_long || at - m < (int64_t)kMax16) {
          ref = m;
          return mlt;
        }
      }
    }
    return 0;
  };
  auto find_faster = [&](uint64_t head, int64_t at, int64_t& ref) -> int64_t {
    uint64_t maxd = (1ull << c.window_log) - 1;
    uint64_t cur = (uint64_t)at + kDict;
    uint64_t low = (kDict + maxd >= cur) ? kDict : cur - maxd;
    ref = -1;
    if (head < cur && head >= low) {
      int64_t m = (int64_t)(head - kDict);
      if (at - m >= 8 && rd32(src + m) == rd32(src + at)) {
        int64_t mlt =
            count_eq(src, m + kMinMatch, at + kMinMatch, matchlimit) +
            kMinMatch;
        if (mlt >= c.mm_long || at - m < (int64_t)kMax16) {
          ref = m;
          return mlt;
        }
      }
    }
    return 0;
  };
  auto emit = [&](int64_t& at, int64_t ml, int64_t ref, bool rep) {
    uint32_t off = rep ? 0 : (uint32_t)(at - ref);
    emit_seq_liz(src, (size_t)anchor, (size_t)at, (size_t)ml, off, a);
    at += ml;
    anchor = at;
  };

  while (ip < mflimit) {
    uint32_t h = c.hpos(ip);
    int64_t ref;
    bool is_rep;
    int64_t ml = find_fast(c.hash[h], ip, ref, is_rep);
    head_update(h, ip);
    if (!ml) {
      ++ip;
      continue;
    }
    int64_t ml2 = 0, start2 = -1, ref2 = -1;
    if (!is_rep && ip - ref == (int64_t)a.last_off) is_rep = true;
    if (!is_rep) {
      int64_t back = 0;
      while (ip + back > anchor && ref + back > 0 &&
             src[ip + back - 1] == src[ref + back - 1])
        --back;
      ml -= back;
      ip += back;
      ref += back;
      goto _search;
    }
    emit(ip, ml, ref, true);
    continue;

  _search:
    if (ip + ml < mflimit) {
      start2 = ip + ml - 2;
      uint32_t h2 = c.hpos(start2);
      ml2 = find_faster(c.hash[h2], start2, ref2);
      head_update(h2, start2);
      if (ml2) {
        int64_t back = 0;
        while (start2 + back > ip && ref2 + back > 0 &&
               src[start2 + back - 1] == src[ref2 + back - 1])
          --back;
        ml2 -= back;
        start2 += back;
        ref2 += back;
        if (ml2 <= ml) {
          ml2 = 0;
        } else if (start2 <= ip) {
          ip = start2;
          ref = ref2;
          ml = ml2;
          ml2 = 0;
        } else if (start2 - ip < 3) {
          ip = start2;
          ref = ref2;
          ml = ml2;
          ml2 = 0;
          goto _search;
        } else {
          if (start2 < ip + ml) {
            int64_t correction = ml - (start2 - ip);
            start2 += correction;
            ref2 += correction;
            ml2 -= correction;
            if (ml2 < 3) ml2 = 0;
            if (ml2 && ml2 < c.mm_long &&
                start2 - ref2 >= (int64_t)kMax16)
              ml2 = 0;
          }
        }
      }
    }
    // post-search encodes always carry the real offset (the oracle's
    // parse_pricefast converts to rep only before the search)
    emit(ip, ml, ref, false);
    if (ml2) {
      ip = start2;
      ref = ref2;
      ml = ml2;
      ml2 = 0;
      goto _search;
    }
  }
  a.lits.insert(a.lits.end(), src + anchor, src + end);
}

// fastBig (lizard_parser_fastbig.h:35-175)
void parse_fastbig(PCtx& c, int64_t start_pos, int64_t end, LizAcc& a) {
  const uint8_t* src = c.src;
  uint64_t maxd = (1ull << c.window_log) - 1;
  int64_t mflimit = end - kMfLimit;
  int64_t matchlimit = end - kLastLit;
  int64_t anchor = start_pos;
  int64_t ip = start_pos;
  constexpr int64_t kMmLongBig = 16;

  auto emit = [&](int64_t& at, int64_t ml, int64_t ref) {
    emit_seq_liz(src, (size_t)anchor, (size_t)at, (size_t)ml,
                 (uint32_t)(at - ref), a);
    at += ml;
    anchor = at;
  };
  auto h_at = [&](int64_t i) { return h5(rd64(src + i), c.hash_log); };
  auto low_for = [&](int64_t at) -> uint64_t {
    uint64_t cur = (uint64_t)at + kDict;
    return (kDict + maxd >= cur) ? kDict : cur - maxd;
  };

  if (end - start_pos < 21) {   // LIZARD_MIN_LENGTH
    a.lits.insert(a.lits.end(), src + anchor, src + end);
    return;
  }
  uint64_t low_limit = low_for(start_pos);
  c.hash[h_at(ip)] = (uint32_t)((uint64_t)ip + kDict);
  ++ip;
  uint32_t forward_h = h_at(ip);

  for (;;) {
    int64_t forward_ip = ip;
    int64_t step = 1;
    int64_t search_match_nb = 1 << kSkipTrigger;
    int64_t m;
    int64_t match_length;
    for (;;) {
      uint32_t h = forward_h;
      ip = forward_ip;
      forward_ip += step;
      step = search_match_nb >> kSkipTrigger;
      ++search_match_nb;
      if (forward_ip > mflimit) {
        a.lits.insert(a.lits.end(), src + anchor, src + end);
        return;
      }
      uint64_t match_index = c.hash[h];
      forward_h = h_at(forward_ip);
      c.hash[h] = (uint32_t)((uint64_t)ip + kDict);
      if (match_index < low_limit ||
          match_index >= (uint64_t)ip + kDict ||
          match_index + maxd < (uint64_t)ip + kDict)
        continue;
      m = (int64_t)(match_index - kDict);
      if (ip - m >= 8 && rd32(src + m) == rd32(src + ip)) {
        int64_t back = 0;
        match_length = count_eq(src, m + kMinMatch, ip + kMinMatch,
                                matchlimit);   // cap at the CURRENT side
        while (ip + back > anchor && m + back > 0 &&
               src[ip + back - 1] == src[m + back - 1])
          --back;
        match_length -= back;
        if (match_length >= kMmLongBig || ip - m < (int64_t)kMax16) {
          ip += back;
          m += back;
          break;
        }
      }
    }

    for (;;) {
      emit(ip, match_length + kMinMatch, m);
      if (ip > mflimit) {
        a.lits.insert(a.lits.end(), src + anchor, src + end);
        return;
      }
      c.hash[h_at(ip - 2)] = (uint32_t)((uint64_t)(ip - 2) + kDict);
      uint64_t match_index = c.hash[h_at(ip)];
      c.hash[h_at(ip)] = (uint32_t)((uint64_t)ip + kDict);
      if (match_index >= low_limit &&
          match_index < (uint64_t)ip + kDict &&
          match_index + maxd >= (uint64_t)ip + kDict) {
        m = (int64_t)(match_index - kDict);
        if (ip - m >= 8 && rd32(src + m) == rd32(src + ip)) {
          match_length =
              count_eq(src, m + kMinMatch, ip + kMinMatch, matchlimit);
          if (match_length >= kMmLongBig || ip - m < (int64_t)kMax16)
            continue;
        }
      }
      break;
    }
    ++ip;
    forward_h = h_at(ip);
  }
}

// level -> PCtx config. Returns the parser kind: 0 = not handled (greedy
// fast path), 1 = noChain, 2 = hashChain, 3 = fastBig, 4 = priceFast,
// 5 = lowestPrice
inline int config_for_level(int level, PCtx& c) {
  int base = level >= 30 ? level - 20 : level;
  c.huff = level >= 30;
  c.mm_long = 16;
  c.sufficient = 1ll << 40;
  switch (base) {
    case 12: c.hash_log = (level == 32 ? 14 : 18); c.window_log = 16;
             c.search_length = 5; return 1;
    case 13: c.hash_log = 18; c.content_log = 16; c.window_log = 16;
             c.search_num = 2;   c.search_length = 5; return 2;
    case 14: c.hash_log = 18; c.content_log = 16; c.window_log = 16;
             c.search_num = 4;   c.search_length = 5; return 2;
    case 15: c.hash_log = 18; c.content_log = 16; c.window_log = 16;
             c.search_num = 8;   c.search_length = 5; return 2;
    case 16: c.hash_log = 18; c.content_log = 16; c.window_log = 16;
             c.search_num = 16;  c.search_length = 4; return 2;
    case 17: c.hash_log = 18; c.content_log = 16; c.window_log = 16;
             c.search_num = 256; c.search_length = 4; return 2;
    // 18/19 are optimalPriceBT in the reference; approximated with the
    // deepest hashChain (ratio lands between -17 and the true -19)
    case 18: c.hash_log = 18; c.content_log = 17; c.window_log = 16;
             c.search_num = 384; c.search_length = 4; return 2;
    case 19: c.hash_log = 21; c.content_log = 17; c.window_log = 16;
             c.search_num = 768; c.search_length = 4; return 2;
    case 20: c.hash_log = 14; c.window_log = 22;
             c.search_length = 5; return 3;
    case 21: c.hash_log = 14; c.window_log = 22;
             c.search_length = 5; return 4;
    case 22: c.hash_log = 18; c.window_log = 22;
             c.search_length = 5; return 4;
    case 23: c.hash_log = 18; c.content_log = 22; c.window_log = 22;
             c.search_num = 1;  c.search_length = 5; c.sufficient = 64;
             return 5;
    case 24: c.hash_log = 23; c.content_log = 22; c.window_log = 22;
             c.search_num = 2;  c.search_length = 5; c.sufficient = 64;
             return 5;
    case 25: c.hash_log = 23; c.content_log = 22; c.window_log = 22;
             c.search_num = 8;  c.search_length = 4; c.sufficient = 64;
             return 5;
    // 26-29 are optimalPrice(BT); approximated with deeper lowestPrice
    case 26: c.hash_log = 23; c.content_log = 23; c.window_log = 22;
             c.search_num = 32; c.search_length = 4; c.sufficient = 128;
             return 5;
    case 27: c.hash_log = 23; c.content_log = 23; c.window_log = 22;
             c.search_num = 128; c.search_length = 4; c.sufficient = 256;
             return 5;
    case 28: c.hash_log = 23; c.content_log = 23; c.window_log = 22;
             c.search_num = 512; c.search_length = 4; c.sufficient = 1024;
             return 5;
    case 29: c.hash_log = 23; c.content_log = 23; c.window_log = 24;
             c.search_num = 1024; c.search_length = 4; c.sufficient = 1024;
             return 5;
    default: return 0;
  }
}

}  // namespace refparse

}  // namespace

extern "C" {

// Compress `src` into a Lizard block stream at any level 10..49. Levels
// map to parser tiers like the reference ladder (lizard_common.h:234-284):
// greedy single-probe finders for the fastest tiers (10-11/30-31 LZ4),
// and faithful ports of this repo's ref/parsers.py decisions for
// noChain (12/32-33), hashChain (13-17/34-38), fastBig (20/40),
// priceFast (21-22/41-42) and lowestPrice (23-25/43-45); the optimal
// tiers (18-19/26-29/39/46-49) run the deepest chain/price parses as an
// approximation. Huff0 entropy stage for levels >= 30. Valid streams for
// liblizard and this repo's decoders; NOT byte-identical to the
// reference encoder (the bit-exact path is lizard_tpu/ref/
// block_encode.py). Returns bytes written or -1 if dst is too small.
int64_t ltpu_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                      int level, int accel) {
  if (level < 10 || level > 49) return -2;
  bool lz4 = level_is_lz4(level);
  bool huff = level >= 30;
  std::vector<uint8_t> out;
  out.reserve(n / 2 + 1024);
  out.push_back((uint8_t)level);
  EncAcc acc;
  LizAcc lacc;
  static const std::vector<uint8_t> kEmpty;
  refparse::PCtx pctx;
  int kind = accel <= 1 ? refparse::config_for_level(level, pctx) : 0;
  if (kind) {
    pctx.src = src;
    pctx.n = (int64_t)n;
    pctx.hash.assign((size_t)1 << pctx.hash_log, 0);
    if (pctx.content_log)
      pctx.chain.assign((size_t)1 << pctx.content_log, 0);
  }
  std::vector<uint32_t> htab;
  if (!kind) htab.assign((size_t)1 << 17, 0xFFFFFFFFu);
  for (size_t b0 = 0; b0 < n; b0 += kBlock) {
    size_t b1 = b0 + kBlock < n ? b0 + kBlock : n;
    if (lz4) {
      if (kind) {
        acc.flags.clear();
        acc.lits.clear();
        // each inner block restarts its parse; the window (tables) spans
        // the whole stream, like Lizard_compress_generic's block loop
        int64_t anchor = (int64_t)b0;
        if (kind == 1)
          refparse::parse_lazy_lz4(pctx, (int64_t)b0, (int64_t)b1, acc,
                                   refparse::find_best_nc,
                                   refparse::wider_nc, false, &anchor);
        else
          refparse::parse_lazy_lz4(pctx, (int64_t)b0, (int64_t)b1, acc,
                                   refparse::find_best_hc,
                                   refparse::wider_hc, true, &anchor);
        acc.lits.insert(acc.lits.end(), src + anchor, src + b1);
      } else {
        encode_inner_lz4(src, b0, b1, n, htab.data(), 17, accel, acc);
      }
      write_block_n(out, src, b0, b1 - b0, acc.flags, acc.lits, kEmpty,
                    kEmpty, huff);
    } else {
      if (kind) {
        lacc.flags.clear();
        lacc.lits.clear();
        lacc.off16.clear();
        lacc.off24.clear();
        lacc.last_off = 0;   // decoder resets last_off per inner block
        if (kind == 3)
          refparse::parse_fastbig(pctx, (int64_t)b0, (int64_t)b1, lacc);
        else if (kind == 4)
          refparse::parse_pricefast(pctx, (int64_t)b0, (int64_t)b1, lacc);
        else
          refparse::parse_lowestprice(pctx, (int64_t)b0, (int64_t)b1, lacc);
      } else {
        encode_inner_liz(src, b0, b1, n, htab.data(), 17, accel, lacc);
      }
      write_block_n(out, src, b0, b1 - b0, lacc.flags, lacc.lits, lacc.off16,
                    lacc.off24, huff);
    }
  }
  if (out.size() > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return (int64_t)out.size();
}

// standalone Huff0 compress (0 = incompressible; caller stores raw)
int64_t ltpu_huf_compress(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t cap) {
  std::vector<uint8_t> out;
  if (!hufenc::huf_compress(src, n, out)) return 0;
  if (out.size() > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return (int64_t)out.size();
}

// ---------------------------------------------------------------------
// Pass B (emission) for the TPU lane encoder: serialize a parsed token
// list (st, ml, off — the kernels' output) into the fastLZ4 / LIZv1
// token streams. Layout mirrors ops/enc_lanes.emit_tokens[_liz] exactly
// (byte-for-byte): the numpy path is the fallback/oracle; this is the
// production host stage (the numpy scatter runs at ~65 MB/s, this at
// memcpy speed).

// fastLZ4: flags[i] = min(ll,15) | min(ml-4,15)<<4; lits stream per
// token = [ext_ll][literals][off LE16][ext_ml], then the tail literals.
// Returns lits length, or -1 if lits_cap is too small. flags length
// is nt by construction.
int64_t ltpu_emit_lz4(const uint8_t* src, int64_t n, const int64_t* st,
                      const int64_t* ml, const int64_t* off, int64_t nt,
                      uint8_t* flags, uint8_t* lits, int64_t lits_cap) {
  int64_t lp = 0, anchor = 0;
  for (int64_t i = 0; i < nt; i++) {
    int64_t ll = st[i] - anchor;
    int64_t mlx = ml[i] - 4;
    if (lp + ll + 10 > lits_cap) return -1;
    flags[i] = (uint8_t)((ll < 15 ? ll : 15) |
                         ((mlx < 15 ? mlx : 15) << 4));
    if (ll >= 15) {
      uint32_t v = (uint32_t)(ll - 15);
      if (v < 254) {
        lits[lp++] = (uint8_t)v;
      } else if (v < 65536) {
        lits[lp++] = 254;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
      } else {
        lits[lp++] = 255;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
        lits[lp++] = (uint8_t)(v >> 16);
      }
    }
    std::memcpy(lits + lp, src + anchor, (size_t)ll);
    lp += ll;
    lits[lp++] = (uint8_t)off[i];
    lits[lp++] = (uint8_t)(off[i] >> 8);
    if (mlx >= 15) {
      uint32_t v = (uint32_t)(mlx - 15);
      if (v < 254) {
        lits[lp++] = (uint8_t)v;
      } else if (v < 65536) {
        lits[lp++] = 254;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
      } else {
        lits[lp++] = 255;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
        lits[lp++] = (uint8_t)(v >> 16);
      }
    }
    anchor = st[i] + ml[i];
  }
  int64_t tail = n - anchor;
  if (lp + tail > lits_cap) return -1;
  std::memcpy(lits + lp, src + anchor, (size_t)tail);
  return lp + tail;
}

// LIZv1 (offsets < 2^16 — the lane encoder's reach; rep class for a
// repeated offset): flags[i] = min(ll,7) | min(ml,15)<<3 | rep<<7;
// lits per token = [ext_ll][literals][ext_ml]; off16 carries LE16
// offsets of non-rep tokens. Returns lits length (or -1 on overflow);
// *off16_len receives the off16 stream length.
int64_t ltpu_emit_liz(const uint8_t* src, int64_t n, const int64_t* st,
                      const int64_t* ml, const int64_t* off, int64_t nt,
                      uint8_t* flags, uint8_t* lits, int64_t lits_cap,
                      uint8_t* off16, int64_t* off16_len) {
  int64_t lp = 0, op = 0, anchor = 0, last_off = -1;
  for (int64_t i = 0; i < nt; i++) {
    int64_t ll = st[i] - anchor;
    int64_t mv = ml[i];
    bool rep = off[i] == last_off;
    if (lp + ll + 10 > lits_cap) return -1;
    flags[i] = (uint8_t)((ll < 7 ? ll : 7) |
                         ((mv < 15 ? mv : 15) << 3) | (rep ? 128 : 0));
    if (ll >= 7) {
      uint32_t v = (uint32_t)(ll - 7);
      if (v < 254) {
        lits[lp++] = (uint8_t)v;
      } else if (v < 65536) {
        lits[lp++] = 254;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
      } else {
        lits[lp++] = 255;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
        lits[lp++] = (uint8_t)(v >> 16);
      }
    }
    std::memcpy(lits + lp, src + anchor, (size_t)ll);
    lp += ll;
    if (mv >= 15) {
      uint32_t v = (uint32_t)(mv - 15);
      if (v < 254) {
        lits[lp++] = (uint8_t)v;
      } else if (v < 65536) {
        lits[lp++] = 254;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
      } else {
        lits[lp++] = 255;
        lits[lp++] = (uint8_t)v;
        lits[lp++] = (uint8_t)(v >> 8);
        lits[lp++] = (uint8_t)(v >> 16);
      }
    }
    if (!rep) {
      off16[op++] = (uint8_t)off[i];
      off16[op++] = (uint8_t)(off[i] >> 8);
      last_off = off[i];
    }
    anchor = st[i] + ml[i];
  }
  int64_t tail = n - anchor;
  if (lp + tail > lits_cap) return -1;
  std::memcpy(lits + lp, src + anchor, (size_t)tail);
  *off16_len = op;
  return lp + tail;
}

// Full-codeword LIZv1 emission incl. the off24 class (lane-encoder pass
// B for token lists containing offsets >= 64K). Reuses emit_seq_liz, so
// literals-carrier tokens, MM_LONGOFF long-match tokens, and rep
// collapsing all follow lizard_compress_liz.h:43-165. Outputs sizes via
// the n* pointers; returns 0, or -1 if a capacity is exceeded.
int64_t ltpu_emit_liz_far(const uint8_t* src, int64_t n, const int64_t* st,
                          const int64_t* ml, const int64_t* off, int64_t nt,
                          uint8_t* flags, int64_t flags_cap, int64_t* nflags,
                          uint8_t* lits, int64_t lits_cap, int64_t* nlits,
                          uint8_t* off16, int64_t* n16,
                          uint8_t* off24, int64_t* n24) {
  LizAcc a;
  int64_t anchor = 0;
  for (int64_t i = 0; i < nt; ++i) {
    uint32_t o = (uint32_t)off[i];
    uint32_t eff = (a.last_off != 0 && o == a.last_off) ? 0 : o;
    emit_seq_liz(src, (size_t)anchor, (size_t)st[i], (size_t)ml[i], eff, a);
    anchor = st[i] + ml[i];
  }
  a.lits.insert(a.lits.end(), src + anchor, src + n);
  if ((int64_t)a.flags.size() > flags_cap ||
      (int64_t)a.lits.size() > lits_cap)
    return -1;
  // empty vectors may return data() == nullptr: UB for memcpy even at n=0
  if (!a.flags.empty()) std::memcpy(flags, a.flags.data(), a.flags.size());
  if (!a.lits.empty()) std::memcpy(lits, a.lits.data(), a.lits.size());
  if (!a.off16.empty()) std::memcpy(off16, a.off16.data(), a.off16.size());
  if (!a.off24.empty()) std::memcpy(off24, a.off24.data(), a.off24.size());
  *nflags = (int64_t)a.flags.size();
  *nlits = (int64_t)a.lits.size();
  *n16 = (int64_t)a.off16.size();
  *n24 = (int64_t)a.off24.size();
  return 0;
}

}  // extern "C"
