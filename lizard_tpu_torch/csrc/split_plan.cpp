// The decoder's host split and Huff0 plan of a whole batch in one pass: the
// native form of ops/split.py (split_stream, split_stored, split_into's
// family check, finalize) and of ops/huf128.py::prepare_huf128 with
// ref/huf.py::huf_read_stats, which stay the plain versions the tests hold
// this file against. ops/host_plan.py drives it through ctypes, twice a
// batch: ltt_split_size walks the block headers and sizes every output,
// the caller allocates them, and ltt_split_plan walks again, writing the
// BlockBatch streams and tables and the HufPlan. Both return 0 or a status
// code (the list below, shared with ops/host_plan.py, which formats the
// messages); err[] then names the input, block, stream kind and segment.
// One thread; nothing is allocated. Built with g++ by
// lizard_tpu_torch/runtime.py::own_library; a host source, not a kernel.
#include <cstdint>
#include <cstring>

namespace {

// status codes, shared with ops/host_plan.py
enum : int64_t {
  OK = 0,
  // the split: CorruptError
  E_EMPTY_STREAM = 1, E_BAD_LEVEL, E_UNC_HEADER, E_UNC_TRUNC, E_FLAG_LEN,
  E_BAD_HEADER, E_STREAM_HEADER, E_STREAM_TRUNC, E_HUF_HEADER, E_HUF_TRUNC,
  E_MIXED,
  // a blob: HufError "<name>: ..."
  E_DST0 = 20, E_CSIZE, E_BODY_SMALL, E_JUMP_OVERFLOW, E_SEGMENTATION,
  // a segment: HufError "<name>, segment k: ..."
  E_SEG_EMPTY = 30, E_SEG_END_MARK,
  // the weights header: HufError with its message alone
  E_W_EMPTY = 40, E_W_TRUNC, E_NC_SMALL, E_NC_TABLELOG, E_NC_CORRUPT,
  E_NC_OVERRAN, E_W_TABLELOG, E_SPREAD, E_BS_EMPTY, E_BS_END_MARK,
  E_FSE_TOO_LARGE, E_W_LARGE, E_W_ZERO, E_HUF_TABLELOG, E_IMPLIED,
  E_DISTRIBUTION,
  // a weights symbol past 255 (the plain version's bytearray refuses it)
  E_BYTE_RANGE = 60,
  // an output past what ltt_split_size gave (a fault of this file)
  E_CAPACITY = 70,
};

// err[] fields
enum { ERR_CODE, ERR_ITEM, ERR_BLOCK, ERR_KIND, ERR_SEGMENT, ERR_VALUE,
       ERR_FIELDS };
// sizes[] fields
enum { SZ_BLOCKS, SZ_FLAGS, SZ_LITERALS, SZ_OFF16, SZ_OFF24, SZ_BLOBS,
       SZ_TABLES, SZ_DATA, SZ_FAMILY, SZ_FAMILIES, SZ_FIELDS };

// the format (format/constants.py)
constexpr int64_t BLOCK_SIZE = 1 << 17;
constexpr int FLAG_LITERALS = 1, FLAG_FLAGS = 2, FLAG_OFFSET16 = 4,
              FLAG_OFFSET24 = 8, FLAG_LEN = 16, FLAG_UNCOMPRESSED = 128;
// stream kinds: the order of split.STREAMS
enum { K_FLAGS, K_LITERALS, K_OFF16, K_OFF24, KINDS };
constexpr int TABLELOG_MAX = 12;                 // HUF_TABLELOG_MAX
constexpr int TABLE_ENTRIES = 1 << TABLELOG_MAX;
constexpr int SEGMENTS = 4;
constexpr int WEIGHTS_MAX = 260;     // 256 decoded weights + the implied one
constexpr int COUNTS_MAX = 4096;     // NCount entries (zero runs included)

inline int64_t le24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (int64_t(p[2]) << 16);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// Bits [lo, lo + n) of the little-endian bit string p[0, len), n <= 24;
// bits outside it read as zeros (lo may be negative).
uint32_t bits(const uint8_t* p, int64_t len, int64_t lo, int n) {
  if (n == 0) return 0;
  int64_t b0 = lo >= 0 ? lo >> 3 : -((7 - lo) >> 3);
  uint64_t v = 0;
  for (int k = 0; k < 4; k++) {
    int64_t j = b0 + k;
    if (j >= 0 && j < len) v |= uint64_t(p[j]) << (8 * k);
  }
  return uint32_t(v >> (lo - 8 * b0)) & ((1u << n) - 1);
}

// One stream of a block: raw bytes, or a Huff0 blob that decodes to orig.
struct Stream {
  const uint8_t* p;
  int64_t n;
  bool huf;
  int64_t orig;
};

// --------------------------------------------------------- weights ------

// The FSE-coded weights (ref/huf.py::fse_decompress at max_out 255):
// the NCount header, the spread table, then two interleaved states over a
// backward bitstream. Writes out[0, *n_out).
int64_t fse_weights(const uint8_t* src, int64_t len, int* out, int* n_out) {
  constexpr int MAX_OUT = 255;
  if (len < 4) return E_NC_SMALL;
  int tl = (src[0] & 0xF) + 5;
  if (tl > 15) return E_NC_TABLELOG;
  int64_t bit = 4;
  int remaining = (1 << tl) + 1, threshold = 1 << tl, nb = tl + 1;
  int counts[COUNTS_MAX];
  int nc = 0;
  bool prev0 = false;
  while (remaining > 1 && nc <= 255) {
    if (prev0) {
      while (bits(src, len, bit, 16) == 0xFFFF) {
        if (nc + 24 > COUNTS_MAX) return E_CAPACITY;
        for (int k = 0; k < 24; k++) counts[nc++] = 0;
        bit += 16;
      }
      while (bits(src, len, bit, 2) == 3) {
        if (nc + 3 > COUNTS_MAX) return E_CAPACITY;
        for (int k = 0; k < 3; k++) counts[nc++] = 0;
        bit += 2;
      }
      int z = bits(src, len, bit, 2);
      if (nc + z + 1 > COUNTS_MAX) return E_CAPACITY;
      for (int k = 0; k < z; k++) counts[nc++] = 0;
      bit += 2;
    }
    int maxv = (2 * threshold - 1) - remaining;
    int window = bits(src, len, bit, 16);
    int val = window & (threshold - 1);
    int count;
    if (val < maxv) {
      count = val;
      bit += nb - 1;
    } else {
      count = window & (2 * threshold - 1);
      if (count >= threshold) count -= maxv;
      bit += nb;
    }
    count -= 1;                       // -1: a probability below one
    remaining -= count < 0 ? -count : count;
    if (nc + 1 > COUNTS_MAX) return E_CAPACITY;
    counts[nc++] = count;
    prev0 = count == 0;
    while (remaining < threshold) {
      nb -= 1;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return E_NC_CORRUPT;
  int64_t consumed = (bit + 7) >> 3;
  if (consumed > len) return E_NC_OVERRAN;
  if (tl > 6) return E_W_TABLELOG;

  // the decode table: -1 symbols from the top, the rest spread
  const int size = 1 << tl;
  int symbols[64], next[COUNTS_MAX];
  int high = size - 1;
  for (int s = 0; s < nc; s++) {
    if (counts[s] == -1) {
      symbols[high--] = s;
      next[s] = 1;
    } else {
      next[s] = counts[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nc; s++) {
    for (int k = 0; k < counts[s]; k++) {
      symbols[pos] = s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) return E_SPREAD;
  int t_sym[64], t_nb[64], t_base[64];
  for (int u = 0; u < size; u++) {
    int s = symbols[u];
    int ns = next[s]++;
    int b = tl - highbit(ns);
    t_sym[u] = s;
    t_nb[u] = b;
    t_base[u] = (ns << b) - size;
  }

  // the backward bitstream after the header
  const uint8_t* bs = src + consumed;
  int64_t blen = len - consumed;
  if (blen < 1) return E_BS_EMPTY;
  if (bs[blen - 1] == 0) return E_BS_END_MARK;
  int64_t bpos = 8 * (blen - 1) + highbit(bs[blen - 1]);  // under the mark
  auto read = [&](int n) {
    uint32_t v = bits(bs, blen, bpos - n, n);
    bpos -= n;
    return int(v);
  };
  int state[2];
  state[0] = read(tl);
  state[1] = read(tl);
  int cur = 0, n = 0;
  for (;;) {
    if (n >= MAX_OUT) return E_FSE_TOO_LARGE;
    int u = state[cur];
    if (t_sym[u] > 255) return E_BYTE_RANGE;
    out[n++] = t_sym[u];
    state[cur] = t_base[u] + read(t_nb[u]);
    cur ^= 1;
    if (bpos < 0) {
      if (t_sym[state[cur]] > 255) return E_BYTE_RANGE;
      out[n++] = t_sym[state[cur]];
      break;
    }
  }
  *n_out = n;
  return OK;
}

// The weights header of a Huff0 blob (ref/huf.py::huf_read_stats): raw
// nibbles or FSE-coded weights, then the implied last weight.
int64_t read_stats(const uint8_t* src, int64_t len, int* w, int* n_w,
                   int* table_log, int64_t* hsize) {
  if (len < 1) return E_W_EMPTY;
  int isize = src[0];
  int n = 0;
  if (isize >= 128) {
    int osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > len) return E_W_TRUNC;
    for (int i = 0; i < osize; i++)
      w[n++] = i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15;
  } else {
    if (isize + 1 > len) return E_W_TRUNC;
    int64_t code = fse_weights(src + 1, isize, w, &n);
    if (code != OK) return code;
  }
  *hsize = isize + 1;
  int64_t total = 0;
  for (int i = 0; i < n; i++) {
    if (w[i] >= TABLELOG_MAX) return E_W_LARGE;
    total += (int64_t(1) << w[i]) >> 1;
  }
  if (total == 0) return E_W_ZERO;
  int tl = highbit(uint32_t(total)) + 1;
  if (tl > TABLELOG_MAX) return E_HUF_TABLELOG;
  int64_t rest = (int64_t(1) << tl) - total;
  if (rest & (rest - 1)) return E_IMPLIED;
  w[n++] = highbit(uint32_t(rest)) + 1;
  int rank1 = 0;
  for (int i = 0; i < n; i++) rank1 += w[i] == 1;
  if (rank1 < 2 || (rank1 & 1)) return E_DISTRIBUTION;
  *n_w = n;
  *table_log = tl;
  return OK;
}

// ----------------------------------------------------------- walks ------

struct Inputs {
  int64_t n;
  const uint8_t* const* src;
  const int64_t* len;
  const uint8_t* stored;        // 1: a stored frame block (split_stored)
  const int8_t* level_family;   // [256]: 0 fastLZ4, 1 LIZv1, -1 no level
  int check_family;             // split_into's "mixed codeword families"
};

inline int64_t fail(int64_t* err, int64_t code, int64_t item, int64_t block,
                    int64_t value = 0) {
  err[ERR_CODE] = code;
  err[ERR_ITEM] = item;
  err[ERR_BLOCK] = block;
  err[ERR_VALUE] = value;
  return code;
}

// The split's walk over every input, with every check of ops/split.py in
// its order; each inner block goes to v.block(item, block, family,
// streams) with family -1 for a stored frame block. *batch_family is the
// family of the first input that is not stored (-1: none). Returns 0 or
// the code of the first fault (in err), or of the first that v.block
// returns.
template <class V>
int64_t walk(const Inputs& in, V& v, int64_t* err, int* batch_family) {
  int64_t block = 0;
  *batch_family = -1;
  for (int64_t i = 0; i < in.n; i++) {
    const uint8_t* s = in.src[i];
    const int64_t n = in.len[i];
    if (in.stored[i]) {
      for (int64_t pos = 0; pos < n; pos += BLOCK_SIZE) {
        Stream st[KINDS] = {};
        st[K_LITERALS] = {s + pos, n - pos < BLOCK_SIZE ? n - pos : BLOCK_SIZE,
                          false, 0};
        int64_t code = v.block(i, block++, -1, st);
        if (code != OK) return code;
      }
      v.item_end(i, block);
      continue;
    }
    if (n < 1) return fail(err, E_EMPTY_STREAM, i, block);
    const int level = s[0];
    const int family = in.level_family[level];
    if (family < 0) return fail(err, E_BAD_LEVEL, i, block, level);
    int64_t ip = 1;
    while (ip < n) {
      const int header = s[ip++];
      Stream st[KINDS] = {};
      if (header == FLAG_UNCOMPRESSED) {
        if (ip > n - 3) return fail(err, E_UNC_HEADER, i, block);
        int64_t len = le24(s + ip);
        ip += 3;
        if (ip + len > n) return fail(err, E_UNC_TRUNC, i, block);
        st[K_LITERALS] = {s + ip, len, false, 0};
        ip += len;
      } else {
        if (header & FLAG_LEN) return fail(err, E_FLAG_LEN, i, block);
        if (header & ~(FLAG_LITERALS | FLAG_FLAGS | FLAG_OFFSET16 |
                       FLAG_OFFSET24))
          return fail(err, E_BAD_HEADER, i, block, header);
        // the len stream (never Huffman-coded, unused), then in order
        static const int order[] = {-1, K_OFF16, K_OFF24, K_FLAGS,
                                    K_LITERALS};
        static const int flag[] = {0, FLAG_OFFSET16, FLAG_OFFSET24,
                                   FLAG_FLAGS, FLAG_LITERALS};
        for (int k = 0; k < 5; k++) {
          Stream r;
          if (!(header & flag[k])) {
            if (ip > n - 3) return fail(err, E_STREAM_HEADER, i, block);
            int64_t len = le24(s + ip);
            if (ip + 3 + len > n) return fail(err, E_STREAM_TRUNC, i, block);
            r = {s + ip + 3, len, false, 0};
            ip += 3 + len;
          } else {
            if (ip > n - 6) return fail(err, E_HUF_HEADER, i, block);
            int64_t orig = le24(s + ip), comp = le24(s + ip + 3);
            if (ip + 6 + comp > n) return fail(err, E_HUF_TRUNC, i, block);
            r = {s + ip + 6, comp, true, orig};
            ip += 6 + comp;
          }
          if (order[k] >= 0) st[order[k]] = r;
        }
      }
      int64_t code = v.block(i, block++, family, st);
      if (code != OK) return code;
    }
    v.item_end(i, block);
    if (*batch_family < 0) {
      *batch_family = family;
    } else if (in.check_family && family != *batch_family) {
      return fail(err, E_MIXED, i, block);
    }
  }
  return OK;
}

// The blob order of a block: that of split._read_stream's calls.
constexpr int BLOB_ORDER[KINDS] = {K_OFF16, K_OFF24, K_FLAGS, K_LITERALS};

// the weights header's size from its first byte (read_stats's hsize)
inline int64_t header_size(uint8_t b) {
  return b >= 128 ? (b - 127 + 1) / 2 + 1 : b + 1;
}

// A blob that the kernel decodes: not stored, not RLE, not empty, and not
// refused by the size checks that come first.
inline bool kernel_blob(const Stream& r) {
  return r.orig != 0 && r.n < r.orig && r.n > 1;
}

struct Sizer {
  int64_t* sz;
  int families = 0;             // bit f: a block of family f

  int64_t block(int64_t, int64_t, int family, const Stream* st) {
    sz[SZ_BLOCKS]++;
    if (family >= 0) families |= 1 << family;
    for (int k = 0; k < KINDS; k++) {
      const Stream& r = st[k];
      sz[SZ_FLAGS + k] += r.huf ? r.orig : r.n;
      if (!r.huf) continue;
      sz[SZ_BLOBS]++;
      if (kernel_blob(r)) {
        int64_t data = r.n - header_size(r.p[0]) - 6;
        sz[SZ_TABLES]++;
        sz[SZ_DATA] += data > 0 ? data : 0;
      }
    }
    return OK;
  }
  void item_end(int64_t, int64_t) {}
};

struct Out {
  uint8_t* flat[KINDS];         // split.STREAMS
  int64_t cap[KINDS];
  int64_t* table;               // (8, n_blocks): TABLE_FIELDS, row by row
  int64_t* stream_id;
  uint8_t* family;              // per block: 1 LIZv1, 0 fastLZ4
  int64_t* item_end;            // per input: the end of its blocks
  uint8_t* data;                // HufPlan.data
  int64_t* segs;                // (4 n_tables, 6)
  uint16_t* tables;             // (n_tables, 4096)
  int32_t* table_log;
  int64_t* where;               // (n_tables, 3): stream id, block, kind
};

struct Filler {
  const Out& o;
  const int64_t* sid;
  int64_t n_blocks, n_tables, n_data;
  int batch_family;
  int64_t* err;
  int64_t cursor[KINDS] = {};   // in each flat stream
  int64_t t = 0, data_at = 0;   // tables and segment bytes so far

  int64_t blob_fault(int64_t code, int64_t item, int64_t block, int kind,
                     int seg = 0) {
    fail(err, code, item, block);
    err[ERR_KIND] = kind;
    err[ERR_SEGMENT] = seg;
    return code;
  }

  // prepare_huf128 for one blob whose hole is at dst in stream `kind`
  int64_t plan(const Stream& r, int64_t item, int64_t block, int kind,
               int64_t dst) {
    uint8_t* hole = o.flat[kind] + dst;
    if (r.orig == 0) return blob_fault(E_DST0, item, block, kind);
    if (r.n > r.orig) return blob_fault(E_CSIZE, item, block, kind);
    if (r.n == r.orig) {                          // stored
      std::memcpy(hole, r.p, r.n);
      return OK;
    }
    if (r.n == 1) {                               // RLE
      std::memset(hole, r.p[0], r.orig);
      return OK;
    }
    std::memset(hole, 0, r.orig);
    int w[WEIGHTS_MAX], n_w = 0, tl = 0;
    int64_t hsize = 0;
    int64_t code = read_stats(r.p, r.n, w, &n_w, &tl, &hsize);
    if (code != OK) return blob_fault(code, item, block, kind);
    const uint8_t* body = r.p + hsize;
    const int64_t blen = r.n - hsize;
    if (blen < 10) return blob_fault(E_BODY_SMALL, item, block, kind);
    int64_t lens[SEGMENTS];
    for (int k = 0; k < 3; k++) lens[k] = body[2 * k] | (body[2 * k + 1] << 8);
    lens[3] = blen - 6 - lens[0] - lens[1] - lens[2];
    if (lens[3] < 0) return blob_fault(E_JUMP_OVERFLOW, item, block, kind);
    const int64_t seg = (r.orig + 3) / 4;
    const int64_t sizes[SEGMENTS] = {seg, seg, seg, r.orig - 3 * seg};
    if (sizes[3] < 0) return blob_fault(E_SEGMENTATION, item, block, kind);
    if (t >= n_tables || data_at + blen - 6 > n_data)
      return blob_fault(E_CAPACITY, item, block, kind);
    int64_t off = 6;
    for (int k = 0; k < SEGMENTS; k++) {
      if (lens[k] == 0) return blob_fault(E_SEG_EMPTY, item, block, kind, k);
      if (body[off + lens[k] - 1] == 0)
        return blob_fault(E_SEG_END_MARK, item, block, kind, k);
      int64_t* row = o.segs + (t * SEGMENTS + k) * 6;
      row[0] = data_at + off - 6;
      row[1] = lens[k];
      row[2] = kind;
      row[3] = dst + k * seg;
      row[4] = sizes[k];
      row[5] = t;
      off += lens[k];
    }
    std::memcpy(o.data + data_at, body + 6, blen - 6);
    data_at += blen - 6;
    // huf128.decode_table: symbols by ascending weight, then value, each
    // (1 << w) >> 1 times as sym | nbits << 8; zeros past 1 << tl
    uint16_t* table = o.tables + t * TABLE_ENTRIES;
    int at = 0;
    for (int wt = 1; wt <= TABLELOG_MAX; wt++) {
      const int reps = (1 << wt) >> 1;
      for (int s = 0; s < n_w; s++) {
        if (w[s] != wt) continue;
        const uint16_t e = uint16_t(s | ((tl + 1 - wt) << 8));
        for (int k = 0; k < reps; k++) table[at++] = e;
      }
    }
    std::memset(table + at, 0, (TABLE_ENTRIES - at) * sizeof(uint16_t));
    o.table_log[t] = tl;
    o.where[3 * t] = sid[item];
    o.where[3 * t + 1] = block;
    o.where[3 * t + 2] = kind;
    t++;
    return OK;
  }

  int64_t block(int64_t item, int64_t b, int family, const Stream* st) {
    if (b >= n_blocks) return fail(err, E_CAPACITY, item, b);
    int64_t dst[KINDS];
    for (int k = 0; k < KINDS; k++) {
      const Stream& r = st[k];
      const int64_t len = r.huf ? r.orig : r.n;
      if (cursor[k] + len > o.cap[k]) return fail(err, E_CAPACITY, item, b);
      dst[k] = cursor[k];
      o.table[(2 * k) * n_blocks + b] = cursor[k];
      o.table[(2 * k + 1) * n_blocks + b] = len;
      if (!r.huf && len) std::memcpy(o.flat[k] + cursor[k], r.p, len);
      cursor[k] += len;
    }
    o.stream_id[b] = sid[item];
    o.family[b] = uint8_t((family >= 0 ? family : batch_family) == 1);
    for (int k : BLOB_ORDER) {
      if (!st[k].huf) continue;
      int64_t code = plan(st[k], item, b, k, dst[k]);
      if (code != OK) return code;
    }
    return OK;
  }
  void item_end(int64_t item, int64_t end) { o.item_end[item] = end; }
};

}  // namespace

extern "C" {

int ltt_split_plan_fields(int64_t* out) {
  out[0] = ERR_FIELDS;
  out[1] = SZ_FIELDS;
  return 0;
}

// Walks every input (src[i], len[i] bytes; stored[i] for a stored frame
// block) with the split's checks, and sizes the outputs of ltt_split_plan:
// sizes[] = blocks, the four flat streams' bytes, Huff0 blobs, kernel
// tables, segment bytes, the batch's family (that of the first input that
// is not stored; -1 none) and a bit mask of the families its blocks use.
int64_t ltt_split_size(int64_t n, const uint8_t* const* src,
                       const int64_t* len, const uint8_t* stored,
                       const int8_t* level_family, int check_family,
                       int64_t* sizes, int64_t* err) {
  Inputs in{n, src, len, stored, level_family, check_family};
  std::memset(sizes, 0, SZ_FIELDS * sizeof(int64_t));
  std::memset(err, 0, ERR_FIELDS * sizeof(int64_t));
  Sizer v{sizes};
  int family = -1;
  int64_t code = walk(in, v, err, &family);
  sizes[SZ_FAMILY] = family;
  sizes[SZ_FAMILIES] = v.families;
  return code;
}

// The split and the plan, into outputs sized by ltt_split_size (`sizes`,
// unchanged): flat[4] the streams, table the (8, blocks) offsets and
// lengths, stream_id and family per block, item_end per input, then the
// HufPlan's data, segs, tables, table_log and each table's (stream id,
// block, kind). sid[i] is input i's stream id.
int64_t ltt_split_plan(int64_t n, const uint8_t* const* src,
                       const int64_t* len, const uint8_t* stored,
                       const int8_t* level_family, int check_family,
                       const int64_t* sid, const int64_t* sizes,
                       uint8_t* const* flat, int64_t* table,
                       int64_t* stream_id, uint8_t* family,
                       int64_t* item_end, uint8_t* data, int64_t* segs,
                       uint16_t* tables, int32_t* table_log, int64_t* where,
                       int64_t* err) {
  Inputs in{n, src, len, stored, level_family, check_family};
  std::memset(err, 0, ERR_FIELDS * sizeof(int64_t));
  Out o{{flat[0], flat[1], flat[2], flat[3]},
        {sizes[SZ_FLAGS], sizes[SZ_LITERALS], sizes[SZ_OFF16],
         sizes[SZ_OFF24]},
        table, stream_id, family, item_end, data, segs, tables, table_log,
        where};
  Filler v{o, sid, sizes[SZ_BLOCKS], sizes[SZ_TABLES], sizes[SZ_DATA],
           sizes[SZ_FAMILY] < 0 ? 0 : int(sizes[SZ_FAMILY]), err};
  int first = -1;
  int64_t code = walk(in, v, err, &first);
  if (code == OK && (v.t != sizes[SZ_TABLES] || v.data_at != sizes[SZ_DATA]))
    return fail(err, E_CAPACITY, n, sizes[SZ_BLOCKS]);
  return code;
}

}  // extern "C"
