// The encoder's Huff0 plan of a whole batch of streams in one pass: the
// native form of ops/enc_huf.py::plan_huf_streams_plain over
// ref/huf_encode.py (fse_count, fse_optimal_table_log, huf_build_ctable
// with huf_sort and huf_set_max_height, huf_write_ctable with
// huf_compress_weights), which stay the plain versions the tests hold this
// file against. ops/enc_huf.py::plan_huf_streams drives it through ctypes,
// once a batch: the streams come joined in one buffer with their offsets,
// and ltt_huf_plan writes every field of the HufEncPlan into outputs sized
// for the whole batch (the caller keeps the first n_coded rows). Returns 0
// or a status code (the list below, shared with ops/enc_huf.py, which
// formats the messages); err[] then names the stream. One thread; nothing
// is allocated. Built with g++ by lizard_tpu_torch/runtime.py::own_library;
// a host source, not a kernel.
#include <cstdint>
#include <cstring>

namespace {

// status codes, shared with ops/enc_huf.py: the ValueErrors of the plain
// version
enum : int64_t {
  OK = 0, E_HUFF_LOG = 1, E_NORMALIZE_M2, E_NCOUNT, E_NCOUNT_OVERRAN,
  E_SPREAD,
  E_CAPACITY = 10,         // a buffer of this file too small (its fault)
};

// err[] fields
enum { ERR_CODE, ERR_STREAM, ERR_FIELDS };
// sizes[] fields
enum { SZ_CODED, SZ_BYTES, SZ_WORDS, SZ_FIELDS };
// kind[] values: how a stream is written
enum : int8_t { STORED = 0, RLE = 1, CODED = 2 };

constexpr int64_t BLOCKSIZE_MAX = 128 * 1024;    // HUF_BLOCKSIZE_MAX
constexpr int TABLELOG_DEFAULT = 11;             // HUF_TABLELOG_DEFAULT
constexpr int TABLELOG_MAX = 12;                 // HUF_TABLELOG_MAX
constexpr int FSE_MIN_TABLELOG = 5, FSE_MAX_TABLELOG = 12;
constexpr int SYMBOLS = 256;                     // TABLE_ENTRIES
constexpr int SEGMENTS = 4, FIELDS = 4, MAXBITS = 11;
constexpr int HEADER_MAX = 128;      // a weights header's bytes, at most
constexpr int WEIGHTS_OUT = 1024;    // room for FSE-coded weights

// Python's int.bit_length() - 1: -1 for 0.
inline int highbit(uint64_t v) { return v ? 63 - __builtin_clzll(v) : -1; }

// BIT_CStream_t: LSB-first bit concatenation into out[0, cap).
struct BitWriter {
  uint8_t* out;
  int64_t cap, len = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool full = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  void add(uint64_t value, int nbits) {
    acc |= (value & ((uint64_t(1) << nbits) - 1)) << nacc;
    nacc += nbits;
    while (nacc >= 8) {
      put(uint8_t(acc));
      acc >>= 8;
      nacc -= 8;
    }
  }
  void put(uint8_t b) {
    if (len < cap) out[len++] = b;
    else full = true;
  }
  // the end mark, then the last partial byte: (bits + 7) / 8 bytes
  int64_t close() {
    add(1, 1);
    if (nacc) put(uint8_t(acc));
    return full ? -1 : len;
  }
};

// ---------------------------------------------------------------- FSE ------

// (count per symbol 0..max_sym, max_sym lowered past the symbols that do
// not occur, to 0 at the lowest; largest count, 0 for no bytes)
void fse_count(const uint8_t* src, int64_t n, uint32_t* count, int* max_sym,
               uint32_t* largest) {
  uint32_t c[4][SYMBOLS];
  memset(c, 0, sizeof(c));
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    c[0][src[i]]++;
    c[1][src[i + 1]]++;
    c[2][src[i + 2]]++;
    c[3][src[i + 3]]++;
  }
  for (; i < n; i++) c[0][src[i]]++;
  int top = 0;
  uint32_t big = 0;
  for (int s = 0; s < SYMBOLS; s++) {
    count[s] = c[0][s] + c[1][s] + c[2][s] + c[3][s];
    if (count[s]) top = s;
    if (count[s] > big) big = count[s];
  }
  *max_sym = top;
  *largest = n ? big : 0;
}

int fse_optimal_table_log(int max_table_log, int64_t src_size, int max_sym,
                          int minus) {
  int max_bits_src = highbit(uint64_t(src_size - 1)) - minus;
  int table_log = max_table_log;
  int min_bits_src = highbit(uint64_t(src_size - 1)) + 1;
  int min_bits_symbols = highbit(uint64_t(max_sym)) + 2;
  int min_bits = min_bits_src < min_bits_symbols ? min_bits_src
                                                 : min_bits_symbols;
  if (table_log == 0) table_log = 11;            // FSE_DEFAULT_TABLELOG
  if (max_bits_src < table_log) table_log = max_bits_src;
  if (min_bits > table_log) table_log = min_bits;
  if (table_log < FSE_MIN_TABLELOG) table_log = FSE_MIN_TABLELOG;
  return table_log > FSE_MAX_TABLELOG ? FSE_MAX_TABLELOG : table_log;
}

// FSE_normalizeM2 (ref/huf_encode.py::_fse_normalize_m2).
int64_t normalize_m2(int64_t* norm, int table_log, const uint32_t* count,
                     int64_t total, int max_sym) {
  int64_t distributed = 0;
  int64_t low_threshold = total >> table_log;
  int64_t low_one = (total * 3) >> (table_log + 1);
  for (int s = 0; s <= max_sym; s++) {
    if (count[s] == 0) {
      norm[s] = 0;
      continue;
    }
    if (count[s] <= low_threshold) {
      norm[s] = -1;
      distributed += 1;
      total -= count[s];
      continue;
    }
    if (count[s] <= low_one) {
      norm[s] = 1;
      distributed += 1;
      total -= count[s];
      continue;
    }
    norm[s] = -2;
  }
  int64_t to_distribute = (int64_t(1) << table_log) - distributed;
  if (to_distribute && total / to_distribute > low_one) {
    low_one = (total * 3) / (to_distribute * 2);
    for (int s = 0; s <= max_sym; s++) {
      if (norm[s] == -2 && count[s] <= low_one) {
        norm[s] = 1;
        distributed += 1;
        total -= count[s];
      }
    }
    to_distribute = (int64_t(1) << table_log) - distributed;
  }
  if (distributed == max_sym + 1) {
    int max_v = 0;
    uint32_t max_c = 0;
    for (int s = 0; s <= max_sym; s++)
      if (count[s] > max_c) {
        max_v = s;
        max_c = count[s];
      }
    norm[max_v] += to_distribute;
    return OK;
  }
  if (total <= 0 || to_distribute < 0) return E_NORMALIZE_M2;
  int v_step_log = 62 - table_log;
  uint64_t mid = (uint64_t(1) << (v_step_log - 1)) - 1;
  uint64_t r_step = ((uint64_t(1) << v_step_log) * uint64_t(to_distribute)
                     + mid) / uint64_t(total);
  uint64_t tmp_total = mid;
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -2) {
      uint64_t end = tmp_total + count[s] * r_step;
      int64_t weight = int64_t(end >> v_step_log)
                       - int64_t(tmp_total >> v_step_log);
      if (weight < 1) return E_NORMALIZE_M2;
      norm[s] = weight;
      tmp_total = end;
    }
  }
  return OK;
}

// FSE_normalizeCount (ref/huf_encode.py::fse_normalize_count): OK (*rle
// set for the rle case, norm then unset) or an error.
int64_t normalize(int64_t* norm, int table_log, const uint32_t* count,
                  int64_t total, int max_sym, bool* rle) {
  static const uint64_t rtb[8] = {0, 473195, 504333, 520860, 550000,
                                  700000, 750000, 830000};
  int scale = 62 - table_log;
  uint64_t step = (uint64_t(1) << 62) / uint64_t(total);
  uint64_t v_step = uint64_t(1) << (scale - 20);
  int64_t still = int64_t(1) << table_log;
  int largest = 0;
  int64_t largest_p = 0;
  uint64_t low_threshold = uint64_t(total) >> table_log;
  *rle = false;
  for (int s = 0; s <= max_sym; s++) {
    uint64_t c = count[s];
    if (c == uint64_t(total)) {
      *rle = true;
      return OK;
    }
    if (c == 0) {
      norm[s] = 0;
      continue;
    }
    if (c <= low_threshold) {
      norm[s] = -1;
      still -= 1;
    } else {
      uint64_t proba = (c * step) >> scale;
      if (proba < 8) {
        uint64_t rest_to_beat = v_step * rtb[proba];
        if (c * step - (proba << scale) > rest_to_beat) proba += 1;
      }
      if (int64_t(proba) > largest_p) {
        largest_p = int64_t(proba);
        largest = s;
      }
      norm[s] = int64_t(proba);
      still -= int64_t(proba);
    }
  }
  if (-still >= (norm[largest] >> 1))
    return normalize_m2(norm, table_log, count, total, max_sym);
  norm[largest] += still;
  return OK;
}

// FSE_writeNCount_generic (ref/huf_encode.py::fse_write_ncount): the
// header's length into *len, or an error.
int64_t write_ncount(const int64_t* norm, int max_sym, int table_log,
                     uint8_t* out, int64_t cap, int64_t* len) {
  int64_t n = 0;
  auto put2 = [&](uint64_t v) {
    if (n + 2 > cap) return false;
    out[n++] = uint8_t(v);
    out[n++] = uint8_t(v >> 8);
    return true;
  };
  uint64_t bit_stream = uint64_t(table_log - FSE_MIN_TABLELOG);
  int bit_count = 4;
  int64_t remaining = (int64_t(1) << table_log) + 1;
  int64_t threshold = int64_t(1) << table_log;
  int nb_bits = table_log + 1;
  int charnum = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      int start = charnum;
      while (charnum <= max_sym && !norm[charnum]) charnum++;
      if (charnum > max_sym) return E_NCOUNT_OVERRAN;
      while (charnum >= start + 24) {
        start += 24;
        bit_stream += uint64_t(0xFFFF) << bit_count;
        if (!put2(bit_stream)) return E_CAPACITY;
        bit_stream >>= 16;
      }
      while (charnum >= start + 3) {
        start += 3;
        bit_stream += uint64_t(3) << bit_count;
        bit_count += 2;
      }
      bit_stream += uint64_t(charnum - start) << bit_count;
      bit_count += 2;
      if (bit_count > 16) {
        if (!put2(bit_stream)) return E_CAPACITY;
        bit_stream >>= 16;
        bit_count -= 16;
      }
    }
    if (charnum > max_sym) return E_NCOUNT_OVERRAN;
    int64_t count = norm[charnum++];
    int64_t maxv = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count += 1;
    if (count >= threshold) count += maxv;
    bit_stream += uint64_t(count) << bit_count;
    bit_count += nb_bits;
    if (count < maxv) bit_count -= 1;
    previous0 = count == 1;
    if (remaining < 1) return E_NCOUNT;
    while (remaining < threshold) {
      nb_bits -= 1;
      threshold >>= 1;
    }
    if (bit_count > 16) {
      if (!put2(bit_stream)) return E_CAPACITY;
      bit_stream >>= 16;
      bit_count -= 16;
    }
  }
  if (!put2(bit_stream)) return E_CAPACITY;
  // the final flush keeps only ceil(bit_count / 8) of the last 2 bytes
  *len = n - 2 + (bit_count + 7) / 8;
  if (charnum > max_sym + 1) return E_NCOUNT_OVERRAN;
  return OK;
}

// FSE_buildCTable_wksp (ref/huf_encode.py::FseCTable).
struct FseCTable {
  int table_log;
  int64_t state_table[1 << FSE_MAX_TABLELOG];
  int64_t delta_nb_bits[SYMBOLS];
  int64_t delta_find_state[SYMBOLS];

  int64_t build(const int64_t* norm, int max_sym, int log) {
    table_log = log;
    int64_t table_size = int64_t(1) << log;
    int64_t high = table_size - 1;
    int64_t cumul[SYMBOLS + 2];
    uint8_t table_symbol[1 << FSE_MAX_TABLELOG];
    memset(table_symbol, 0, sizeof(table_symbol));
    cumul[0] = 0;
    for (int u = 1; u <= max_sym + 1; u++) {
      if (norm[u - 1] == -1) {
        cumul[u] = cumul[u - 1] + 1;
        table_symbol[high--] = uint8_t(u - 1);
      } else {
        cumul[u] = cumul[u - 1] + norm[u - 1];
      }
    }
    cumul[max_sym + 1] = table_size + 1;
    int64_t step = (table_size >> 1) + (table_size >> 3) + 3;
    int64_t mask = table_size - 1;
    int64_t pos = 0;
    for (int s = 0; s <= max_sym; s++) {
      for (int64_t k = 0; k < norm[s]; k++) {
        table_symbol[pos] = uint8_t(s);
        pos = (pos + step) & mask;
        while (pos > high) pos = (pos + step) & mask;
      }
    }
    if (pos != 0) return E_SPREAD;
    for (int64_t u = 0; u < table_size; u++) {
      int s = table_symbol[u];
      int64_t at = cumul[s]++;
      if (at < 0 || at >= table_size) return E_SPREAD;
      state_table[at] = table_size + u;
    }
    int64_t total = 0;
    for (int s = 0; s <= max_sym; s++) {
      int64_t n = norm[s];
      delta_nb_bits[s] = delta_find_state[s] = 0;
      if (n == 0) continue;
      if (n == -1 || n == 1) {
        delta_nb_bits[s] = (int64_t(log) << 16) - (int64_t(1) << log);
        delta_find_state[s] = total - 1;
        total += 1;
      } else {
        int64_t max_bits_out = log - highbit(uint64_t(n - 1));
        int64_t min_state_plus = n << max_bits_out;
        delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus;
        delta_find_state[s] = total - n;
        total += n;
      }
    }
    return OK;
  }
};

// FSE_initCState2, FSE_encodeSymbol, FSE_flushCState.
struct FseCState {
  const FseCTable* ct;
  int64_t value;

  FseCState(const FseCTable* t, int first) : ct(t) {
    int64_t d = ct->delta_nb_bits[first];
    int64_t nb_bits_out = (d + (1 << 15)) >> 16;
    int64_t v = (nb_bits_out << 16) - d;
    value = ct->state_table[(v >> nb_bits_out) + ct->delta_find_state[first]];
  }
  void encode(BitWriter& bw, int symbol) {
    int64_t nb_bits_out = (value + ct->delta_nb_bits[symbol]) >> 16;
    bw.add(uint64_t(value), int(nb_bits_out));
    value = ct->state_table[(value >> nb_bits_out)
                            + ct->delta_find_state[symbol]];
  }
  void flush(BitWriter& bw) { bw.add(uint64_t(value), ct->table_log); }
};

// FSE_compress_usingCTable_generic (ref/huf_encode.py::
// fse_compress_using_ctable): the bitstream's length, 0 for n <= 2, or -1
// where it does not fit out[0, cap).
int64_t fse_compress(const uint8_t* src, int64_t n, const FseCTable& ct,
                     uint8_t* out, int64_t cap) {
  if (n <= 2) return 0;
  BitWriter bw(out, cap);
  bool odd = n & 1;
  FseCState c1(&ct, src[odd ? n - 1 : n - 2]);
  FseCState c2(&ct, src[odd ? n - 2 : n - 1]);
  int64_t ip = n - 2;
  if (odd) {
    c1.encode(bw, src[ip - 1]);
    ip -= 1;
  }
  if ((n - 2) & 2) {
    c2.encode(bw, src[ip - 1]);
    c1.encode(bw, src[ip - 2]);
    ip -= 2;
  }
  while (ip > 0) {
    c2.encode(bw, src[ip - 1]);
    c1.encode(bw, src[ip - 2]);
    c2.encode(bw, src[ip - 3]);
    c1.encode(bw, src[ip - 4]);
    ip -= 4;
  }
  c2.flush(bw);
  c1.flush(bw);
  return bw.close();
}

// ---------------------------------------------------------------- HUF ------

// HUF_compressWeights (ref/huf_encode.py::huf_compress_weights): the
// length of the NCount header and FSE bitstream written to out, 0 where
// the plain version returns an int (not compressible, or rle), or a
// negative error.
int64_t compress_weights(const uint8_t* weights, int wt_size, uint8_t* out,
                         int64_t cap) {
  if (wt_size <= 1) return 0;
  uint32_t count[SYMBOLS];
  int max_sym;
  uint32_t max_count;
  fse_count(weights, wt_size, count, &max_sym, &max_count);
  if (max_count == uint32_t(wt_size)) return 0;     // rle
  if (max_count == 1) return 0;
  int table_log = fse_optimal_table_log(6, wt_size, max_sym, 2);
  int64_t norm[SYMBOLS] = {0};
  bool rle;
  int64_t st = normalize(norm, table_log, count, wt_size, max_sym, &rle);
  if (st) return -st;
  if (rle) return 0;
  int64_t hlen;
  if ((st = write_ncount(norm, max_sym, table_log, out, cap, &hlen)))
    return -st;
  FseCTable ct;
  if ((st = ct.build(norm, max_sym, table_log))) return -st;
  int64_t blen = fse_compress(weights, wt_size, ct, out + hlen, cap - hlen);
  if (blen < 0) return -E_CAPACITY;
  if (blen == 0) return 0;
  return hlen + blen;
}

struct Node {
  uint32_t count;
  uint16_t parent;
  uint8_t byte;
  uint8_t nb_bits;
};
constexpr int STARTNODE = SYMBOLS;        // HUF_SYMBOLVALUE_MAX + 1

// HUF_sort (ref/huf_encode.py::huf_sort): rank-bucketed insertion sort
// into node[0, max_sym].
void huf_sort(Node* node, const uint32_t* count, int max_sym) {
  uint32_t base[32] = {0}, cur[32];
  for (int n = 0; n <= max_sym; n++) base[highbit(count[n] + 1)]++;
  for (int n = 30; n > 0; n--) base[n - 1] += base[n];
  memcpy(cur, base, sizeof(base));
  for (int n = 0; n <= max_sym; n++) {
    uint32_t c = count[n];
    int r = highbit(c + 1) + 1;
    uint32_t pos = cur[r]++;
    while (pos > base[r] && c > node[pos - 1].count) {
      node[pos] = node[pos - 1];
      pos--;
    }
    node[pos].count = c;
    node[pos].byte = uint8_t(n);
  }
}

// HUF_setMaxHeight (ref/huf_encode.py::huf_set_max_height) on the sorted
// leaves node[0, last_non_null].
int set_max_height(Node* node, int last_non_null, int max_nb_bits) {
  int largest_bits = node[last_non_null].nb_bits;
  if (largest_bits <= max_nb_bits) return largest_bits;
  int64_t total_cost = 0;
  int64_t base_cost = int64_t(1) << (largest_bits - max_nb_bits);
  int n = last_non_null;
  while (node[n].nb_bits > max_nb_bits) {
    total_cost += base_cost - (int64_t(1) << (largest_bits - node[n].nb_bits));
    node[n].nb_bits = uint8_t(max_nb_bits);
    n--;
  }
  while (node[n].nb_bits == max_nb_bits) n--;
  total_cost >>= largest_bits - max_nb_bits;

  constexpr uint32_t NO_SYMBOL = 0xF0F0F0F0;
  uint32_t rank_last[TABLELOG_MAX + 2];
  for (auto& r : rank_last) r = NO_SYMBOL;
  int current_nb_bits = max_nb_bits;
  for (int pos = n; pos >= 0; pos--) {
    if (node[pos].nb_bits >= current_nb_bits) continue;
    current_nb_bits = node[pos].nb_bits;
    rank_last[max_nb_bits - current_nb_bits] = uint32_t(pos);
  }
  while (total_cost > 0) {
    int n_bits_to_decrease = highbit(uint64_t(total_cost)) + 1;
    for (; n_bits_to_decrease > 1; n_bits_to_decrease--) {
      uint32_t high_pos = rank_last[n_bits_to_decrease];
      uint32_t low_pos = rank_last[n_bits_to_decrease - 1];
      if (high_pos == NO_SYMBOL) continue;
      if (low_pos == NO_SYMBOL) break;
      if (node[high_pos].count <= 2 * node[low_pos].count) break;
    }
    while (n_bits_to_decrease <= TABLELOG_MAX
           && rank_last[n_bits_to_decrease] == NO_SYMBOL)
      n_bits_to_decrease++;
    if (rank_last[n_bits_to_decrease] == NO_SYMBOL) return -1;
    total_cost -= int64_t(1) << (n_bits_to_decrease - 1);
    if (rank_last[n_bits_to_decrease - 1] == NO_SYMBOL)
      rank_last[n_bits_to_decrease - 1] = rank_last[n_bits_to_decrease];
    node[rank_last[n_bits_to_decrease]].nb_bits++;
    if (rank_last[n_bits_to_decrease] == 0) {
      rank_last[n_bits_to_decrease] = NO_SYMBOL;
    } else {
      rank_last[n_bits_to_decrease]--;
      if (node[rank_last[n_bits_to_decrease]].nb_bits
          != max_nb_bits - n_bits_to_decrease)
        rank_last[n_bits_to_decrease] = NO_SYMBOL;
    }
  }
  while (total_cost < 0) {
    if (rank_last[1] == NO_SYMBOL) {
      while (node[n].nb_bits == max_nb_bits) n--;
      node[n + 1].nb_bits--;
      rank_last[1] = uint32_t(n + 1);
      total_cost++;
      continue;
    }
    node[rank_last[1] + 1].nb_bits--;
    rank_last[1]++;
    total_cost++;
  }
  return max_nb_bits;
}

// HUF_buildCTable_wksp (ref/huf_encode.py::huf_build_ctable): nbBits and
// the canonical code of every symbol 0..max_sym; returns huffLog, or -1.
// At least two symbols occur.
int build_ctable(const uint32_t* count, int max_sym, int max_nb_bits,
                 uint8_t* sym_nb_bits, uint32_t* sym_val) {
  Node table[1 + 2 * SYMBOLS];
  memset(table, 0, sizeof(table));
  Node* node = table + 1;                 // node[-1]: the barrier
  huf_sort(node, count, max_sym);
  int non_null_rank = max_sym;
  while (node[non_null_rank].count == 0) non_null_rank--;
  int low_s = non_null_rank;
  int node_nb = STARTNODE;
  int node_root = node_nb + low_s - 1;
  int low_n = node_nb;
  node[node_nb].count = node[low_s].count + node[low_s - 1].count;
  node[low_s].parent = node[low_s - 1].parent = uint16_t(node_nb);
  node_nb++;
  low_s -= 2;
  for (int n = node_nb; n <= node_root; n++) node[n].count = 1u << 30;
  node[-1].count = 1u << 31;
  while (node_nb <= node_root) {
    int n1 = node[low_s].count < node[low_n].count ? low_s-- : low_n++;
    int n2 = node[low_s].count < node[low_n].count ? low_s-- : low_n++;
    node[node_nb].count = node[n1].count + node[n2].count;
    node[n1].parent = node[n2].parent = uint16_t(node_nb);
    node_nb++;
  }
  node[node_root].nb_bits = 0;
  for (int n = node_root - 1; n >= STARTNODE; n--)
    node[n].nb_bits = uint8_t(node[node[n].parent].nb_bits + 1);
  for (int n = 0; n <= non_null_rank; n++)
    node[n].nb_bits = uint8_t(node[node[n].parent].nb_bits + 1);

  max_nb_bits = set_max_height(node, non_null_rank, max_nb_bits);
  if (max_nb_bits < 0 || max_nb_bits > TABLELOG_MAX) return -1;

  uint32_t nb_per_rank[TABLELOG_MAX + 1] = {0};
  uint32_t val_per_rank[TABLELOG_MAX + 1] = {0};
  for (int n = 0; n <= non_null_rank; n++) nb_per_rank[node[n].nb_bits]++;
  uint32_t minv = 0;
  for (int b = max_nb_bits; b > 0; b--) {
    val_per_rank[b] = minv;
    minv += nb_per_rank[b];
    minv >>= 1;
  }
  for (int n = 0; n <= max_sym; n++) sym_nb_bits[node[n].byte] = node[n].nb_bits;
  for (int s = 0; s <= max_sym; s++) sym_val[s] = val_per_rank[sym_nb_bits[s]]++;
  return max_nb_bits;
}

// HUF_writeCTable (ref/huf_encode.py::huf_write_ctable): the header's
// length in out[0, HEADER_MAX), 0 where the plain version returns None
// (the stream is stored), or a negative error.
int64_t write_ctable(const uint8_t* sym_nb_bits, int max_sym, int huff_log,
                     uint8_t* out) {
  uint8_t bits_to_weight[TABLELOG_MAX + 1] = {0};
  for (int n = 1; n <= huff_log; n++)
    bits_to_weight[n] = uint8_t(huff_log + 1 - n);
  uint8_t weights[SYMBOLS];
  for (int n = 0; n < max_sym; n++) weights[n] = bits_to_weight[sym_nb_bits[n]];
  uint8_t fse[WEIGHTS_OUT];
  int64_t res = compress_weights(weights, max_sym, fse, WEIGHTS_OUT);
  if (res < 0) return res;
  if (res > 1 && res < max_sym / 2) {
    out[0] = uint8_t(res);
    memcpy(out + 1, fse, res);
    return res + 1;
  }
  // raw 4-bit nibbles
  if (max_sym > 256 - 128) return 0;
  weights[max_sym] = 0;
  int64_t len = 0;
  out[len++] = uint8_t(128 + (max_sym - 1));
  for (int n = 0; n < max_sym; n += 2)
    out[len++] = uint8_t((weights[n] << 4) + weights[n + 1]);
  return len;
}

}  // namespace

extern "C" {

// The constants ops/enc_huf.py must agree with.
void ltt_huf_plan_consts(int64_t* out) {
  const int64_t c[] = {ERR_FIELDS, SZ_FIELDS, SYMBOLS, SEGMENTS, FIELDS,
                       HEADER_MAX, BLOCKSIZE_MAX};
  memcpy(out, c, sizeof(c));
}

// The plan of the n streams src[offs[i], offs[i + 1]), in order (ops/
// enc_huf.py::plan_huf_streams_plain):
// - kind[i]: STORED (empty, over BLOCKSIZE_MAX, no count over n/128 + 1,
//   or a weights header that is missing or leaves no gain), RLE (one byte
//   value), or CODED;
// - coded stream t (coded[t] its index): its bytes appended to data, the
//   four rows segs[4t .. 4t + 3] (src_off, len, table_row t, out_word_off),
//   its table row tables[t][256] (nbits << 16 | code, 0 past max_sym) and
//   its weights header, headers[t * HEADER_MAX ..] of header_len[t] bytes;
// - sizes[]: the coded streams, data's bytes and the output words.
// Outputs hold room for n streams (data for every byte of src).
int64_t ltt_huf_plan(int64_t n, const uint8_t* src, const int64_t* offs,
                     int8_t* kind, int64_t* coded, uint8_t* data,
                     int64_t* segs, int32_t* tables, uint8_t* headers,
                     int64_t* header_len, int64_t* sizes, int64_t* err) {
  int64_t n_coded = 0, cursor = 0, words = 0;
  uint32_t count[SYMBOLS];
  uint8_t nb[SYMBOLS];
  uint32_t val[SYMBOLS];
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* s = src + offs[i];
    int64_t len = offs[i + 1] - offs[i];
    kind[i] = STORED;
    if (len == 0 || len > BLOCKSIZE_MAX) continue;
    int max_sym;
    uint32_t largest;
    fse_count(s, len, count, &max_sym, &largest);
    if (int64_t(largest) == len) {
      kind[i] = RLE;
      continue;
    }
    if (int64_t(largest) <= (len >> 7) + 1) continue;
    int huff_log = fse_optimal_table_log(TABLELOG_DEFAULT, len, max_sym, 1);
    memset(nb, 0, sizeof(nb));
    huff_log = build_ctable(count, max_sym, huff_log, nb, val);
    if (huff_log < 0) {
      err[ERR_CODE] = E_HUFF_LOG;
      err[ERR_STREAM] = i;
      return E_HUFF_LOG;
    }
    uint8_t* header = headers + n_coded * HEADER_MAX;
    int64_t hlen = write_ctable(nb, max_sym, huff_log, header);
    if (hlen < 0) {
      err[ERR_CODE] = -hlen;
      err[ERR_STREAM] = i;
      return -hlen;
    }
    if (hlen == 0 || hlen + 12 >= len) continue;
    kind[i] = CODED;
    coded[n_coded] = i;
    header_len[n_coded] = hlen;
    int32_t* row = tables + n_coded * SYMBOLS;
    for (int k = 0; k < SYMBOLS; k++)
      row[k] = k <= max_sym ? int32_t((uint32_t(nb[k]) << 16) | val[k]) : 0;
    int64_t seg = (len + 3) / 4;
    for (int k = 0; k < SEGMENTS; k++) {
      int64_t length = k < 3 ? seg : len - 3 * seg;
      int64_t* r = segs + (SEGMENTS * n_coded + k) * FIELDS;
      r[0] = cursor + k * seg;
      r[1] = length;
      r[2] = n_coded;
      r[3] = words;
      words += (length * MAXBITS + 31) / 32 + 1;
    }
    memcpy(data + cursor, s, len);
    cursor += len;
    n_coded++;
  }
  sizes[SZ_CODED] = n_coded;
  sizes[SZ_BYTES] = cursor;
  sizes[SZ_WORDS] = words;
  return OK;
}

}  // extern "C"
