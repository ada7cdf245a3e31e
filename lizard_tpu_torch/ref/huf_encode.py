"""The Huff0 encoder, bit-exact with the reference entropy backend
(lib/entropy/huf_compress.c, fse_compress.c): the port's copy of
lizard_tpu/ref/huf_encode.py.

- count with the trimming of FSE_count (`fse_count`, numpy's bincount);
- tree build: HUF_sort's rank-bucket insertion (huf_compress.c:305-325),
  the parent construction (:334-401), HUF_setMaxHeight's 11-bit limit
  (:223-297) and the canonical values per rank (:382-397);
- the weights header: HUF_writeCTable (:132-165) with FSE-compressed weights
  (HUF_compressWeights :81-121, FSE_normalizeCount fse_compress.c:577-636,
  FSE_writeNCount :204-300, FSE_compress_usingCTable :700-757).

Exact replication matters: the tie-breaks of HUF_sort and the rounding of
the normalisation decide the canonical code, hence the compressed sizes.
The device encoder packs the bitstreams in ops/enc_huf.py (the kernel B8
and its plain version); the oracle packs them serially here
(`_huf_encode_1x`, `huf_compress`, the 4-stream HUF_compress with its
RLE, not-compressible, header and segment-size gates). Counts stay
Python ints: the normalisation multiplies them by steps of up to 2^62.
"""

import numpy as np

from lizard_tpu_torch.ref.huf import FSE_MIN_TABLELOG, HUF_TABLELOG_MAX, _highbit32

HUF_TABLELOG_DEFAULT = 11
FSE_MAX_TABLELOG = 12  # FSE_MAX_MEMORY_USAGE(14) - 2


class BitWriter:
    """BIT_CStream_t model: LSB-first bit concatenation; close() appends the
    end-mark bit (bitstream.h:181-248)."""

    __slots__ = ("acc", "nbits")

    def __init__(self):
        self.acc = 0
        self.nbits = 0

    def add(self, value, nbits):
        self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits

    def close(self) -> bytes:
        self.add(1, 1)
        return self.acc.to_bytes((self.nbits + 7) // 8, "little")


# ---------------------------------------------------------------- FSE ------

def fse_min_table_log(src_size, max_sym):
    min_bits_src = _highbit32(src_size - 1) + 1
    min_bits_symbols = _highbit32(max_sym) + 2
    return min(min_bits_src, min_bits_symbols)


def fse_optimal_table_log(max_table_log, src_size, max_sym, minus):
    max_bits_src = _highbit32(src_size - 1) - minus
    table_log = max_table_log
    min_bits = fse_min_table_log(src_size, max_sym)
    if table_log == 0:
        table_log = 11  # FSE_DEFAULT_TABLELOG
    if max_bits_src < table_log:
        table_log = max_bits_src
    if min_bits > table_log:
        table_log = min_bits
    return min(max(table_log, FSE_MIN_TABLELOG), FSE_MAX_TABLELOG)


_RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)


def fse_normalize_count(table_log, count, total, max_sym):
    """FSE_normalizeCount (fse_compress.c:577-636). Returns the normalised
    counts, or None for the rle special case."""
    norm = [0] * (max_sym + 1)
    scale = 62 - table_log
    step = (1 << 62) // total
    v_step = 1 << (scale - 20)
    still = 1 << table_log
    largest = 0
    largest_p = 0
    low_threshold = total >> table_log

    for s in range(max_sym + 1):
        c = count[s]
        if c == total:
            return None  # rle
        if c == 0:
            norm[s] = 0
            continue
        if c <= low_threshold:
            norm[s] = -1
            still -= 1
        else:
            proba = (c * step) >> scale
            if proba < 8:
                rest_to_beat = v_step * _RTB_TABLE[proba]
                if c * step - (proba << scale) > rest_to_beat:
                    proba += 1
            if proba > largest_p:
                largest_p = proba
                largest = s
            norm[s] = proba
            still -= proba

    if -still >= (norm[largest] >> 1):
        _fse_normalize_m2(norm, table_log, count, total, max_sym)
    else:
        norm[largest] += still
    return norm


def _fse_normalize_m2(norm, table_log, count, total, max_sym):
    """FSE_normalizeM2 (fse_compress.c:506-574)."""
    distributed = 0
    low_threshold = total >> table_log
    low_one = (total * 3) >> (table_log + 1)

    for s in range(max_sym + 1):
        if count[s] == 0:
            norm[s] = 0
            continue
        if count[s] <= low_threshold:
            norm[s] = -1
            distributed += 1
            total -= count[s]
            continue
        if count[s] <= low_one:
            norm[s] = 1
            distributed += 1
            total -= count[s]
            continue
        norm[s] = -2

    to_distribute = (1 << table_log) - distributed
    if to_distribute and (total // to_distribute) > low_one:
        low_one = (total * 3) // (to_distribute * 2)
        for s in range(max_sym + 1):
            if norm[s] == -2 and count[s] <= low_one:
                norm[s] = 1
                distributed += 1
                total -= count[s]
        to_distribute = (1 << table_log) - distributed

    if distributed == max_sym + 1:
        max_v = max_c = 0
        for s in range(max_sym + 1):
            if count[s] > max_c:
                max_v, max_c = s, count[s]
        norm[max_v] += to_distribute
        return

    v_step_log = 62 - table_log
    mid = (1 << (v_step_log - 1)) - 1
    r_step = (((1 << v_step_log) * to_distribute) + mid) // total
    tmp_total = mid
    for s in range(max_sym + 1):
        if norm[s] == -2:
            end = tmp_total + count[s] * r_step
            weight = (end >> v_step_log) - (tmp_total >> v_step_log)
            if weight < 1:
                raise ValueError("normalizeM2 failed")
            norm[s] = weight
            tmp_total = end


def fse_write_ncount(norm, max_sym, table_log) -> bytes:
    """FSE_writeNCount_generic (fse_compress.c:204-289)."""
    out = bytearray()
    bit_stream = (table_log - FSE_MIN_TABLELOG)
    bit_count = 4
    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nb_bits = table_log + 1
    charnum = 0
    previous0 = False

    while remaining > 1:
        if previous0:
            start = charnum
            while not norm[charnum]:
                charnum += 1
            while charnum >= start + 24:
                start += 24
                bit_stream += 0xFFFF << bit_count
                out.append(bit_stream & 0xFF)
                out.append((bit_stream >> 8) & 0xFF)
                bit_stream >>= 16
            while charnum >= start + 3:
                start += 3
                bit_stream += 3 << bit_count
                bit_count += 2
            bit_stream += (charnum - start) << bit_count
            bit_count += 2
            if bit_count > 16:
                out.append(bit_stream & 0xFF)
                out.append((bit_stream >> 8) & 0xFF)
                bit_stream >>= 16
                bit_count -= 16
        count = norm[charnum]
        charnum += 1
        maxv = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1
        if count >= threshold:
            count += maxv
        bit_stream += count << bit_count
        bit_count += nb_bits
        if count < maxv:
            bit_count -= 1
        previous0 = count == 1
        if remaining < 1:
            raise ValueError("writeNCount failed")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
        if bit_count > 16:
            out.append(bit_stream & 0xFF)
            out.append((bit_stream >> 8) & 0xFF)
            bit_stream >>= 16
            bit_count -= 16

    out.append(bit_stream & 0xFF)
    out.append((bit_stream >> 8) & 0xFF)
    # the final flush keeps only ceil(bit_count / 8) of the last 2 bytes
    n = len(out) - 2 + (bit_count + 7) // 8
    if charnum > max_sym + 1:
        raise ValueError("writeNCount overran symbols")
    return bytes(out[:n])


class FseCTable:
    """FSE_buildCTable_wksp (fse_compress.c:103-185)."""

    def __init__(self, norm, max_sym, table_log):
        table_size = 1 << table_log
        self.table_log = table_log
        high = table_size - 1
        cumul = [0] * (max_sym + 2)
        table_symbol = [0] * table_size

        for u in range(1, max_sym + 2):
            if norm[u - 1] == -1:
                cumul[u] = cumul[u - 1] + 1
                table_symbol[high] = u - 1
                high -= 1
            else:
                cumul[u] = cumul[u - 1] + norm[u - 1]
        cumul[max_sym + 1] = table_size + 1

        step = (table_size >> 1) + (table_size >> 3) + 3
        mask = table_size - 1
        pos = 0
        for s in range(max_sym + 1):
            for _ in range(max(norm[s], 0)):
                table_symbol[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ValueError("ctable spread failed")

        self.state_table = [0] * table_size
        for u in range(table_size):
            s = table_symbol[u]
            self.state_table[cumul[s]] = table_size + u
            cumul[s] += 1

        self.delta_nb_bits = [0] * (max_sym + 1)
        self.delta_find_state = [0] * (max_sym + 1)
        total = 0
        for s in range(max_sym + 1):
            n = norm[s]
            if n == 0:
                continue
            if n in (-1, 1):
                self.delta_nb_bits[s] = (table_log << 16) - (1 << table_log)
                self.delta_find_state[s] = total - 1
                total += 1
            else:
                max_bits_out = table_log - _highbit32(n - 1)
                min_state_plus = n << max_bits_out
                self.delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus
                self.delta_find_state[s] = total - n
                total += n


class _FseCState:
    __slots__ = ("value", "ct")

    def __init__(self, ct, first_symbol):
        # FSE_initCState2 (fse.h:540-549)
        self.ct = ct
        nb_bits_out = (ct.delta_nb_bits[first_symbol] + (1 << 15)) >> 16
        value = (nb_bits_out << 16) - ct.delta_nb_bits[first_symbol]
        self.value = ct.state_table[(value >> nb_bits_out)
                                    + ct.delta_find_state[first_symbol]]

    def encode(self, bw, symbol):
        nb_bits_out = (self.value + self.ct.delta_nb_bits[symbol]) >> 16
        bw.add(self.value, nb_bits_out)
        self.value = self.ct.state_table[
            (self.value >> nb_bits_out) + self.ct.delta_find_state[symbol]]

    def flush(self, bw):
        bw.add(self.value, self.ct.table_log)


def fse_compress_using_ctable(src, ct) -> bytes:
    """FSE_compress_usingCTable_generic (fse_compress.c:700-757)."""
    n = len(src)
    if n <= 2:
        return b""
    bw = BitWriter()
    ip = n
    if n & 1:
        c1 = _FseCState(ct, src[ip - 1])
        c2 = _FseCState(ct, src[ip - 2])
        ip -= 2
        c1.encode(bw, src[ip - 1])
        ip -= 1
    else:
        c2 = _FseCState(ct, src[ip - 1])
        c1 = _FseCState(ct, src[ip - 2])
        ip -= 2
    if (n - 2) & 2:
        c2.encode(bw, src[ip - 1])
        c1.encode(bw, src[ip - 2])
        ip -= 2
    while ip > 0:
        c2.encode(bw, src[ip - 1])
        c1.encode(bw, src[ip - 2])
        c2.encode(bw, src[ip - 3])
        c1.encode(bw, src[ip - 4])
        ip -= 4
    c2.flush(bw)
    c1.flush(bw)
    return bw.close()


def fse_count(src, max_sym):
    """(count per symbol 0..max_sym' as Python ints, max_sym', largest
    count): max_sym' is max_sym lowered past the symbols that do not occur
    (to 0 at the lowest), largest is 0 for an empty src. A symbol above
    max_sym raises ValueError."""
    count = np.bincount(np.frombuffer(bytes(src), np.uint8),
                        minlength=max_sym + 1)
    if count.size > max_sym + 1:
        raise ValueError(f"a symbol above max_sym {max_sym}")
    nz = np.flatnonzero(count)
    max_sym = int(nz[-1]) if nz.size else 0
    count = count[:max_sym + 1].tolist()
    return count, max_sym, max(count) if len(src) else 0


# ---------------------------------------------------------------- HUF ------

def huf_compress_weights(weights) -> bytes | int:
    """HUF_compressWeights (huf_compress.c:81-121). Returns the compressed
    bytes, or 0 (not compressible) or 1 (rle) as ints."""
    wt_size = len(weights)
    if wt_size <= 1:
        return 0
    count, max_sym, max_count = fse_count(weights, HUF_TABLELOG_MAX)
    if max_count == wt_size:
        return 1
    if max_count == 1:
        return 0
    table_log = fse_optimal_table_log(6, wt_size, max_sym, minus=2)
    norm = fse_normalize_count(table_log, count, wt_size, max_sym)
    if norm is None:
        return 1
    header = fse_write_ncount(norm, max_sym, table_log)
    ct = FseCTable(norm, max_sym, table_log)
    body = fse_compress_using_ctable(weights, ct)
    if not body:
        return 0
    return header + body


def huf_sort(count, max_sym):
    """HUF_sort (huf_compress.c:305-325): rank-bucketed insertion sort.
    Returns (counts, bytes) in the reference's exact order."""
    rank_base = [0] * 32
    for n in range(max_sym + 1):
        r = _highbit32(count[n] + 1)
        rank_base[r] += 1
    for n in range(30, 0, -1):
        rank_base[n - 1] += rank_base[n]
    rank_cur = rank_base[:]
    node_count = [0] * (max_sym + 1)
    node_byte = [0] * (max_sym + 1)
    for n in range(max_sym + 1):
        c = count[n]
        r = _highbit32(c + 1) + 1
        pos = rank_cur[r]
        rank_cur[r] += 1
        while pos > rank_base[r] and c > node_count[pos - 1]:
            node_count[pos] = node_count[pos - 1]
            node_byte[pos] = node_byte[pos - 1]
            pos -= 1
        node_count[pos] = c
        node_byte[pos] = n
    return node_count, node_byte


def huf_set_max_height(nb_bits, counts, last_non_null, max_nb_bits):
    """HUF_setMaxHeight (huf_compress.c:223-297). Mutates nb_bits in place."""
    largest_bits = nb_bits[last_non_null]
    if largest_bits <= max_nb_bits:
        return largest_bits

    total_cost = 0
    base_cost = 1 << (largest_bits - max_nb_bits)
    n = last_non_null
    while nb_bits[n] > max_nb_bits:
        total_cost += base_cost - (1 << (largest_bits - nb_bits[n]))
        nb_bits[n] = max_nb_bits
        n -= 1
    while nb_bits[n] == max_nb_bits:
        n -= 1

    total_cost >>= largest_bits - max_nb_bits

    NO_SYMBOL = 0xF0F0F0F0
    rank_last = [NO_SYMBOL] * (HUF_TABLELOG_MAX + 2)
    current_nb_bits = max_nb_bits
    for pos in range(n, -1, -1):
        if nb_bits[pos] >= current_nb_bits:
            continue
        current_nb_bits = nb_bits[pos]
        rank_last[max_nb_bits - current_nb_bits] = pos

    while total_cost > 0:
        n_bits_to_decrease = _highbit32(total_cost) + 1
        while n_bits_to_decrease > 1:
            high_pos = rank_last[n_bits_to_decrease]
            low_pos = rank_last[n_bits_to_decrease - 1]
            if high_pos == NO_SYMBOL:
                n_bits_to_decrease -= 1
                continue
            if low_pos == NO_SYMBOL:
                break
            if counts[high_pos] <= 2 * counts[low_pos]:
                break
            n_bits_to_decrease -= 1
        while (n_bits_to_decrease <= HUF_TABLELOG_MAX
               and rank_last[n_bits_to_decrease] == NO_SYMBOL):
            n_bits_to_decrease += 1
        total_cost -= 1 << (n_bits_to_decrease - 1)
        if rank_last[n_bits_to_decrease - 1] == NO_SYMBOL:
            rank_last[n_bits_to_decrease - 1] = rank_last[n_bits_to_decrease]
        nb_bits[rank_last[n_bits_to_decrease]] += 1
        if rank_last[n_bits_to_decrease] == 0:
            rank_last[n_bits_to_decrease] = NO_SYMBOL
        else:
            rank_last[n_bits_to_decrease] -= 1
            if (nb_bits[rank_last[n_bits_to_decrease]]
                    != max_nb_bits - n_bits_to_decrease):
                rank_last[n_bits_to_decrease] = NO_SYMBOL

    while total_cost < 0:
        if rank_last[1] == NO_SYMBOL:
            while nb_bits[n] == max_nb_bits:
                n -= 1
            nb_bits[n + 1] -= 1
            rank_last[1] = n + 1
            total_cost += 1
            continue
        nb_bits[rank_last[1] + 1] -= 1
        rank_last[1] += 1
        total_cost += 1

    return max_nb_bits


def huf_build_ctable(count, max_sym, max_nb_bits):
    """HUF_buildCTable_wksp (huf_compress.c:334-401). Returns (nbBits per
    symbol, code value per symbol, huffLog)."""
    node_count, node_byte = huf_sort(count, max_sym)

    non_null_rank = max_sym
    while node_count[non_null_rank] == 0:
        non_null_rank -= 1

    # internal nodes come after the leaves; index offset = STARTNODE
    n_internal = non_null_rank  # nodeRoot - STARTNODE + 1
    icounts = [0] * max(n_internal, 1)
    parents = {}
    low_s = non_null_rank
    icounts[0] = node_count[low_s] + node_count[low_s - 1]
    parents[low_s] = parents[low_s - 1] = ("i", 0)
    node_nb = 1
    low_s -= 2
    low_n = 0
    iparents = {}
    # the fake barrier: leaf index -1 counts 2^31, unbuilt internals 2^30
    BIG = 1 << 30

    def leaf_count(i):
        return node_count[i] if i >= 0 else (1 << 31)

    def icount(i):
        return icounts[i] if i < node_nb else BIG

    while node_nb < n_internal:
        if leaf_count(low_s) < icount(low_n):
            n1 = ("l", low_s)
            low_s -= 1
        else:
            n1 = ("i", low_n)
            low_n += 1
        if leaf_count(low_s) < icount(low_n):
            n2 = ("l", low_s)
            low_s -= 1
        else:
            n2 = ("i", low_n)
            low_n += 1
        icounts[node_nb] = (
            (leaf_count(n1[1]) if n1[0] == "l" else icounts[n1[1]])
            + (leaf_count(n2[1]) if n2[0] == "l" else icounts[n2[1]]))
        for nd in (n1, n2):
            if nd[0] == "l":
                parents[nd[1]] = ("i", node_nb)
            else:
                iparents[nd[1]] = node_nb
        node_nb += 1

    # distribute nbBits
    root = n_internal - 1
    inb = [0] * max(n_internal, 1)
    for i in range(root - 1, -1, -1):
        inb[i] = inb[iparents[i]] + 1
    nb_bits = [0] * (max_sym + 1)
    for i in range(non_null_rank + 1):
        nb_bits[i] = inb[parents[i][1]] + 1

    max_nb_bits = huf_set_max_height(nb_bits, node_count, non_null_rank,
                                     max_nb_bits)
    if max_nb_bits > HUF_TABLELOG_MAX:
        raise ValueError("huffLog too large")

    # canonical values per rank, in symbol order
    nb_per_rank = [0] * (HUF_TABLELOG_MAX + 1)
    for i in range(non_null_rank + 1):
        nb_per_rank[nb_bits[i]] += 1
    val_per_rank = [0] * (HUF_TABLELOG_MAX + 1)
    minv = 0
    for b in range(max_nb_bits, 0, -1):
        val_per_rank[b] = minv
        minv += nb_per_rank[b]
        minv >>= 1

    sym_nb_bits = [0] * (max_sym + 1)
    for i in range(max_sym + 1):
        sym_nb_bits[node_byte[i]] = nb_bits[i]
    sym_val = [0] * (max_sym + 1)
    for s in range(max_sym + 1):
        sym_val[s] = val_per_rank[sym_nb_bits[s]]
        val_per_rank[sym_nb_bits[s]] += 1

    return sym_nb_bits, sym_val, max_nb_bits


def huf_write_ctable(sym_nb_bits, max_sym, huff_log) -> bytes | None:
    """HUF_writeCTable (huf_compress.c:132-165). Returns None where the
    reference returns an error (more than 128 symbols whose FSE-compressed
    weights do not shrink enough, so they cannot go as raw nibbles): the
    reference and the native encoder then store the stream raw. The JAX
    package's copy raises ValueError there."""
    bits_to_weight = [0] * (HUF_TABLELOG_MAX + 1)
    for n in range(1, huff_log + 1):
        bits_to_weight[n] = huff_log + 1 - n
    weights = bytes(bits_to_weight[sym_nb_bits[n]] for n in range(max_sym))

    res = huf_compress_weights(weights)
    if isinstance(res, bytes) and 1 < len(res) < max_sym // 2:
        return bytes([len(res)]) + res

    # raw 4-bit nibbles
    if max_sym > 256 - 128:
        return None
    w = list(weights) + [0]
    out = bytearray([128 + (max_sym - 1)])
    for n in range(0, max_sym, 2):
        out.append((w[n] << 4) + w[n + 1])
    return bytes(out)


# ------------------------------------------------- serial 4-stream encode --

def _huf_encode_1x(src, sym_val, sym_nb_bits) -> bytes:
    """HUF_compress1X_usingCTable (huf_compress.c:427-470): symbols encoded
    back-to-front in the reference's exact order."""
    bw = BitWriter()
    n = len(src) & ~3
    rem = len(src) & 3
    if rem >= 3:
        bw.add(sym_val[src[n + 2]], sym_nb_bits[src[n + 2]])
    if rem >= 2:
        bw.add(sym_val[src[n + 1]], sym_nb_bits[src[n + 1]])
    if rem >= 1:
        bw.add(sym_val[src[n]], sym_nb_bits[src[n]])
    while n > 0:
        bw.add(sym_val[src[n - 1]], sym_nb_bits[src[n - 1]])
        bw.add(sym_val[src[n - 2]], sym_nb_bits[src[n - 2]])
        bw.add(sym_val[src[n - 3]], sym_nb_bits[src[n - 3]])
        bw.add(sym_val[src[n - 4]], sym_nb_bits[src[n - 4]])
        n -= 4
    return bw.close()


def huf_compress(src: bytes) -> bytes | None:
    """HUF_compress (4 streams, maxSymbolValue 255, tableLog 11,
    huf_compress.c:473-574): the serial encoder of the oracle. Returns the
    compressed blob, the one byte of an RLE stream, or None where the
    reference returns 0 (not compressible enough, a header that leaves no
    gain or cannot be written, a segment over 0xFFFF bytes): the caller then
    stores the stream raw."""
    n = len(src)
    if n == 0:
        return None
    if n > 128 * 1024:
        raise ValueError("HUF block too large")

    count, max_sym, largest = fse_count(src, 255)
    if largest == n:
        return src[:1]  # rle
    if largest <= (n >> 7) + 1:
        return None  # not compressible enough

    huff_log = fse_optimal_table_log(HUF_TABLELOG_DEFAULT, n, max_sym, minus=1)
    sym_nb_bits, sym_val, huff_log = huf_build_ctable(count, max_sym, huff_log)
    header = huf_write_ctable(sym_nb_bits, max_sym, huff_log)
    if header is None or len(header) + 12 >= n:
        return None

    seg = (n + 3) // 4
    parts = []
    for i in range(4):
        chunk = src[i * seg: (i + 1) * seg] if i < 3 else src[3 * seg:]
        c = _huf_encode_1x(chunk, sym_val, sym_nb_bits)
        if len(c) == 0 or len(c) > 0xFFFF:
            return None
        parts.append(c)
    jump = b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
    out = header + jump + b"".join(parts)
    if len(out) >= n - 1:
        return None
    return out
