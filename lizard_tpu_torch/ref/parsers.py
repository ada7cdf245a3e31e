"""Match-finder parsers: noChain, hashChain, fastBig, priceFast, lowestPrice
(the port's copy of lizard_tpu/ref/parsers.py).

Each function replicates the corresponding reference parser's decisions
exactly (same candidate order, same tie-breaks, same lazy-overlap
arbitration), so compressed output is byte-identical:

- noChain:    lib/lizard_parser_nochain.h
- hashChain:  lib/lizard_parser_hashchain.h
- fastBig:    lib/lizard_parser_fastbig.h
- priceFast:  lib/lizard_parser_pricefast.h
- lowestPrice: lib/lizard_parser_lowestprice.h

Index space: table entries are (src position + DICT), matching the
reference's `base = src - LIZARD_DICT_SIZE` convention. Tables are
zero-initialized; index 0 is below every lowLimit so it reads as "empty".
"""

from lizard_tpu_torch.format.constants import (
    LASTLITERALS,
    LIZARD_MAX_16BIT_OFFSET,
    LIZARD_MIN_LENGTH,
    MFLIMIT,
    MINMATCH,
    SKIP_TRIGGER,
)
from lizard_tpu_torch.ref.block_encode import (
    DICT,
    _count,
    _read32,
    _read64,
    encode_last_literals,
    encode_seq_liz,
    encode_seq_lz4,
    hash4,
    hash5,
    hash_ptr,
)
from lizard_tpu_torch.ref.price import get_price_liz

M32 = 0xFFFFFFFF
OPTIMAL_ML = 15 - 1 + MINMATCH  # 18
MAX_PRICE = 1 << 28


def _hash_pos(ctx, src, i):
    return hash_ptr(src, i, ctx.params.hash_log, ctx.params.search_length)


def insert_hc(ctx, src, tables, target_pos):
    """Lizard_Insert (lizard_parser_hashchain.h:13-41): fill chain deltas and
    conditionally the hash heads for positions [next_to_update, target)."""
    chain = tables.chain
    htab = tables.hash
    mask = (1 << ctx.params.content_log) - 1
    max_distance = (1 << ctx.params.window_log) - 1
    target = target_pos + DICT
    idx = tables.next_to_update
    while idx < target:
        h = _hash_pos(ctx, src, idx - DICT)
        delta = (idx - htab[h]) & ((1 << 64) - 1)
        if delta > max_distance:
            delta = max_distance
        chain[idx & mask] = delta
        if htab[h] >= idx or idx >= htab[h] + 8:
            htab[h] = idx
        idx += 1
    tables.next_to_update = target


def insert_nochain(ctx, src, tables, target_pos):
    """Lizard_InsertNoChain (lizard_parser_nochain.h:8-24): hash5 heads only,
    min-offset-8 update rule."""
    htab = tables.hash
    hlog = ctx.params.hash_log
    target = target_pos + DICT
    idx = tables.next_to_update
    while idx < target:
        h = hash5(_read64(src, idx - DICT), hlog)
        if htab[h] >= idx or idx >= htab[h] + 8:
            htab[h] = idx
        idx += 1
    tables.next_to_update = target


def _low_limit(ctx, pos):
    max_distance = (1 << ctx.params.window_log) - 1
    current = pos + DICT
    return DICT if DICT + max_distance >= current else current - max_distance


# ------------------------------------------------------- LZ4-family ---------

def _find_best_nochain(ctx, src, tables, ip, ilimit):
    """Lizard_InsertAndFindBestMatchNoChain (lizard_parser_nochain.h:27-74)."""
    insert_nochain(ctx, src, tables, ip)
    low = _low_limit(ctx, ip)
    cur = ip + DICT
    mi = tables.hash[hash5(_read64(src, ip), ctx.params.hash_log)]
    if mi < cur and mi >= low:
        m = mi - DICT
        if ip - m >= 8 and src[m] == src[ip] and _read32(src, m) == _read32(src, ip):
            ml = _count(src, ip + MINMATCH, m + MINMATCH, ilimit) + MINMATCH
            return ml, m
    return 0, -1


def _wider_nochain(ctx, src, tables, ip, ilow, ihigh, longest):
    """Lizard_InsertAndGetWiderMatchNoChain (lizard_parser_nochain.h:77-140)."""
    insert_nochain(ctx, src, tables, ip)
    low = _low_limit(ctx, ip)
    cur = ip + DICT
    ll_delta = ip - ilow
    mi = tables.hash[hash5(_read64(src, ip), ctx.params.hash_log)]
    best = (longest, -1, -1)
    if mi < cur and mi >= low:
        m = mi - DICT
        if ip - m >= 8 and src[ilow + longest] == src[m - ll_delta + longest]:
            if _read32(src, m) == _read32(src, ip):
                mlt = MINMATCH + _count(src, ip + MINMATCH, m + MINMATCH, ihigh)
                back = 0
                while ip + back > ilow and m + back > 0 and src[ip + back - 1] == src[m + back - 1]:
                    back -= 1
                mlt -= back
                if mlt > longest:
                    best = (mlt, m + back, ip + back)
    return best


def _find_best_hc(ctx, src, tables, ip, ilimit):
    """Lizard_InsertAndFindBestMatch (lizard_parser_hashchain.h:45-106)."""
    insert_hc(ctx, src, tables, ip)
    chain = tables.chain
    mask = (1 << ctx.params.content_log) - 1
    low = _low_limit(ctx, ip)
    cur = ip + DICT
    mi = tables.hash[_hash_pos(ctx, src, ip)]
    attempts = ctx.params.search_num
    ml, pos = 0, -1
    while mi < cur and mi >= low and attempts:
        attempts -= 1
        m = mi - DICT
        if ip - m >= 8 and src[m + ml] == src[ip + ml] and _read32(src, m) == _read32(src, ip):
            mlt = _count(src, ip + MINMATCH, m + MINMATCH, ilimit) + MINMATCH
            if mlt > ml:
                ml, pos = mlt, m
        delta = chain[mi & mask]
        if delta > mi:
            break
        mi -= delta
    return ml, pos


def _wider_hc(ctx, src, tables, ip, ilow, ihigh, longest):
    """Lizard_InsertAndGetWiderMatch (lizard_parser_hashchain.h:109-185)."""
    insert_hc(ctx, src, tables, ip)
    chain = tables.chain
    mask = (1 << ctx.params.content_log) - 1
    low = _low_limit(ctx, ip)
    cur = ip + DICT
    ll_delta = ip - ilow
    mi = tables.hash[_hash_pos(ctx, src, ip)]
    attempts = ctx.params.search_num
    best = (longest, -1, -1)
    while mi < cur and mi >= low and attempts:
        attempts -= 1
        m = mi - DICT
        if ip - m >= 8 and src[ilow + best[0]] == src[m - ll_delta + best[0]]:
            if _read32(src, m) == _read32(src, ip):
                mlt = MINMATCH + _count(src, ip + MINMATCH, m + MINMATCH, ihigh)
                back = 0
                while ip + back > ilow and m + back > 0 and src[ip + back - 1] == src[m + back - 1]:
                    back -= 1
                mlt -= back
                if mlt > best[0]:
                    best = (mlt, m + back, ip + back)
        delta = chain[mi & mask]
        if delta > mi:
            break
        mi -= delta
    return best


def _parse_lazy_lz4(ctx, src, start, end, tables, find_best, get_wider, hc_fit_check):
    """Shared lazy-overlap driver of Lizard_compress_noChain /
    _hashChain (lizard_parser_nochain.h:143-318, _hashchain.h:188-369).
    `hc_fit_check` enables hashChain's extra "match2 doesn't fit" branch."""
    anchor = start
    mflimit = end - MFLIMIT
    matchlimit = end - LASTLITERALS
    ip = start + 1

    while ip < mflimit:
        ml, ref = find_best(ctx, src, tables, ip, matchlimit)
        if not ml:
            ip += 1
            continue

        start0, ref0, ml0 = ip, ref, ml
        label = "search2"
        start2 = ref2 = start3 = ref3 = -1
        ml2 = ml3 = 0

        while True:
            if label == "search2":
                if ip + ml < mflimit:
                    ml2, ref2, start2 = get_wider(ctx, src, tables, ip + ml - 2,
                                                  ip + 1, matchlimit, ml)
                else:
                    ml2 = ml
                if ml2 == ml:
                    ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml, ref)
                    label = "outer"
                    break
                if start0 < ip and start2 < ip + ml0:
                    ip, ref, ml = start0, ref0, ml0
                if start2 - ip < 3:
                    ml, ip, ref = ml2, start2, ref2
                    continue  # goto search2
                label = "search3"
                continue

            if label == "search3":
                if start2 - ip < OPTIMAL_ML:
                    new_ml = min(ml, OPTIMAL_ML)
                    if ip + new_ml > start2 + ml2 - MINMATCH:
                        new_ml = (start2 - ip) + ml2 - MINMATCH
                        if hc_fit_check and new_ml < MINMATCH:
                            ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml, ref)
                            label = "outer"
                            break
                    correction = new_ml - (start2 - ip)
                    if correction > 0:
                        start2 += correction
                        ref2 += correction
                        ml2 -= correction
                if start2 + ml2 < mflimit:
                    ml3, ref3, start3 = get_wider(ctx, src, tables,
                                                  start2 + ml2 - 3, start2,
                                                  matchlimit, ml2)
                else:
                    ml3 = ml2
                if ml3 == ml2:
                    if start2 < ip + ml:
                        ml = start2 - ip
                    ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml, ref)
                    ip = start2
                    ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml2, ref2)
                    label = "outer"
                    break
                if start3 < ip + ml + 3:
                    if start3 >= ip + ml:
                        if start2 < ip + ml:
                            correction = ip + ml - start2
                            start2 += correction
                            ref2 += correction
                            ml2 -= correction
                            if ml2 < MINMATCH:
                                start2, ref2, ml2 = start3, ref3, ml3
                        ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml, ref)
                        ip, ref, ml = start3, ref3, ml3
                        start0, ref0, ml0 = start2, ref2, ml2
                        label = "search2"
                        continue
                    start2, ref2, ml2 = start3, ref3, ml3
                    continue  # goto search3

                # 3 ascending matches
                if start2 < ip + ml:
                    if start2 - ip < 15:
                        if ml > OPTIMAL_ML:
                            ml = OPTIMAL_ML
                        if ip + ml > start2 + ml2 - MINMATCH:
                            ml = (start2 - ip) + ml2 - MINMATCH
                            if ml < MINMATCH:
                                ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml, ref)
                                ip, ref, ml = start3, ref3, ml3
                                start0, ref0, ml0 = start2, ref2, ml2
                                label = "search2"
                                continue
                        correction = ml - (start2 - ip)
                        if correction > 0:
                            start2 += correction
                            ref2 += correction
                            ml2 -= correction
                    else:
                        ml = start2 - ip
                ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, ml, ref)
                ip, ref, ml = start2, ref2, ml2
                start2, ref2, ml2 = start3, ref3, ml3
                label = "search3"
                continue

    encode_last_literals(ctx, src, anchor, end)
    return anchor


def parse_nochain(ctx, src, start, end, tables):
    _parse_lazy_lz4(ctx, src, start, end, tables,
                    _find_best_nochain, _wider_nochain, hc_fit_check=False)


def parse_hashchain(ctx, src, start, end, tables):
    _parse_lazy_lz4(ctx, src, start, end, tables,
                    _find_best_hc, _wider_hc, hc_fit_check=True)


# ------------------------------------------------------ LIZv1-family --------

def parse_fastbig(ctx, src, start, end, tables):
    """Lizard_compress_fastBig (lizard_parser_fastbig.h:35-175): like fast but
    hashLog from params (hash5), and offsets >= 64K require ML >= 16."""
    htab = tables.hash
    hlog = ctx.params.hash_log
    mm_long = 16  # LIZARD_FASTBIG_LONGOFF_MM
    max_distance = (1 << ctx.params.window_log) - 1
    low_limit = DICT if DICT + max_distance >= start + DICT else start + DICT - max_distance
    mflimit = end - MFLIMIT
    matchlimit = end - LASTLITERALS
    anchor = start
    ip = start

    def h_at(i):
        return hash5(_read64(src, i), hlog)

    if end - start < LIZARD_MIN_LENGTH:
        encode_last_literals(ctx, src, anchor, end)
        return

    htab[h_at(ip)] = ip + DICT
    ip += 1
    forward_h = h_at(ip)

    while True:
        forward_ip = ip
        step = 1
        search_match_nb = 1 << SKIP_TRIGGER
        while True:
            h = forward_h
            ip = forward_ip
            forward_ip += step
            step = search_match_nb >> SKIP_TRIGGER
            search_match_nb += 1
            if forward_ip > mflimit:
                encode_last_literals(ctx, src, anchor, end)
                return
            match_index = htab[h]
            forward_h = h_at(forward_ip)
            htab[h] = ip + DICT
            if (match_index < low_limit or match_index >= ip + DICT
                    or match_index + max_distance < ip + DICT):
                continue
            m = match_index - DICT
            if ip - m >= 8 and _read32(src, m) == _read32(src, ip):
                back = 0
                match_length = _count(src, ip + MINMATCH, m + MINMATCH, matchlimit)
                while (ip + back > anchor and m + back > 0
                       and src[ip + back - 1] == src[m + back - 1]):
                    back -= 1
                match_length -= back
                if match_length >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                    ip += back
                    m += back
                    break

        while True:
            ip, anchor = encode_seq_liz(ctx, src, anchor, ip,
                                        match_length + MINMATCH, m)
            if ip > mflimit:
                encode_last_literals(ctx, src, anchor, end)
                return
            htab[h_at(ip - 2)] = ip - 2 + DICT
            match_index = htab[h_at(ip)]
            htab[h_at(ip)] = ip + DICT
            if (match_index >= low_limit and match_index < ip + DICT
                    and match_index + max_distance >= ip + DICT):
                m = match_index - DICT
                if ip - m >= 8 and _read32(src, m) == _read32(src, ip):
                    match_length = _count(src, ip + MINMATCH, m + MINMATCH, matchlimit)
                    if match_length >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                        continue
            break

        ip += 1
        forward_h = h_at(ip)


def _find_match_fast(ctx, src, tables, match_index, ip, ilimit):
    """Lizard_FindMatchFast (lizard_parser_pricefast.h:3-87). Returns
    (ml, match_pos, is_rep)."""
    max_distance = (1 << ctx.params.window_log) - 1
    cur = ip + DICT
    low = DICT if DICT + max_distance >= cur else cur - max_distance
    mm_long = ctx.params.mm_long_off

    if ctx.last_off >= 8:
        ilo = cur - ctx.last_off
        if ilo >= low:
            m = ilo - DICT
            if _read32(src, m) == _read32(src, ip):
                mlt = _count(src, ip + MINMATCH, m + MINMATCH, ilimit) + MINMATCH
                return mlt, m, True

    ml, pos = 0, -1
    if match_index < cur and match_index >= low:
        m = match_index - DICT
        if ip - m >= 8:
            if src[m + ml] == src[ip + ml] and _read32(src, m) == _read32(src, ip):
                mlt = _count(src, ip + MINMATCH, m + MINMATCH, ilimit) + MINMATCH
                if mlt >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                    if not ml or mlt > ml:
                        ml, pos = mlt, m
    return ml, pos, False


def _find_match_faster(ctx, src, match_index, ip, ilimit):
    """Lizard_FindMatchFaster (lizard_parser_pricefast.h:90-128)."""
    max_distance = (1 << ctx.params.window_log) - 1
    cur = ip + DICT
    low = DICT if DICT + max_distance >= cur else cur - max_distance
    mm_long = ctx.params.mm_long_off
    if match_index < cur and match_index >= low:
        m = match_index - DICT
        if ip - m >= 8 and _read32(src, m) == _read32(src, ip):
            mlt = _count(src, ip + MINMATCH, m + MINMATCH, ilimit) + MINMATCH
            if mlt >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                return mlt, m
    return 0, -1


def parse_pricefast(ctx, src, start, end, tables):
    """Lizard_compress_priceFast (lizard_parser_pricefast.h:132-249)."""
    anchor = start
    mflimit = end - MFLIMIT
    matchlimit = end - LASTLITERALS
    htab = tables.hash
    mm_long = ctx.params.mm_long_off
    ip = start + 1

    while ip < mflimit:
        h = _hash_pos(ctx, src, ip)
        ml, ref, is_rep = _find_match_fast(ctx, src, tables, htab[h], ip, matchlimit)
        cur = ip + DICT
        if htab[h] >= cur or cur >= htab[h] + 8:
            htab[h] = cur
        if not ml:
            ip += 1
            continue

        ml2, start2, ref2 = 0, -1, -1
        if not is_rep and ip - ref == ctx.last_off:
            is_rep = True
        if is_rep:
            # encode as rep immediately, no back extension
            ml2 = 0
            ref = ip  # rep marker for the encoder
            label = "encode"
        else:
            back = 0
            while ip + back > anchor and ref + back > 0 and src[ip + back - 1] == src[ref + back - 1]:
                back -= 1
            ml -= back
            ip += back
            ref += back
            label = "search"

        while True:
            if label == "search":
                if ip + ml >= mflimit:
                    label = "encode"
                    continue
                start2 = ip + ml - 2
                h2 = _hash_pos(ctx, src, start2)
                ml2, ref2 = _find_match_faster(ctx, src, htab[h2], start2, matchlimit)
                cur2 = start2 + DICT
                if htab[h2] >= cur2 or cur2 >= htab[h2] + 8:
                    htab[h2] = cur2
                if not ml2:
                    label = "encode"
                    continue
                back = 0
                while (start2 + back > ip and ref2 + back > 0
                       and src[start2 + back - 1] == src[ref2 + back - 1]):
                    back -= 1
                ml2 -= back
                start2 += back
                ref2 += back
                if ml2 <= ml:
                    ml2 = 0
                    label = "encode"
                    continue
                if start2 <= ip:
                    ip, ref, ml = start2, ref2, ml2
                    ml2 = 0
                    label = "encode"
                    continue
                if start2 - ip < 3:
                    ip, ref, ml = start2, ref2, ml2
                    ml2 = 0
                    label = "search"
                    continue
                if start2 < ip + ml:
                    correction = ml - (start2 - ip)
                    start2 += correction
                    ref2 += correction
                    ml2 -= correction
                    if ml2 < 3:
                        ml2 = 0
                    if ml2 < mm_long and start2 - ref2 >= LIZARD_MAX_16BIT_OFFSET:
                        ml2 = 0
                label = "encode"
                continue

            # encode
            ip, anchor = encode_seq_liz(ctx, src, anchor, ip, ml, ref)
            if ml2:
                ip, ref, ml = start2, ref2, ml2
                ml2 = 0
                label = "search"
                continue
            break

    encode_last_literals(ctx, src, anchor, end)


def _better_price(ctx, src, best_ip, best_off, best_common, ip, off, common, last_off):
    """Lizard_better_price (lizard_parser_lowestprice.h:20-26)."""
    if off == last_off:
        off = 0
    if best_off == last_off:
        best_off = 0
    return (get_price_liz(ctx, last_off, src, ip, 0, off, common)
            < get_price_liz(ctx, last_off, src, best_ip, common - best_common, best_off, best_common))


def _more_profitable(ctx, src, best_ip, best_off, best_common, ip, off, common, literals, last_off):
    """Lizard_more_profitable (lizard_parser_lowestprice.h:4-17)."""
    # `literals` is size_t in C and the call site passes a pointer
    # difference that can be negative -> wraps to a huge unsigned value; the
    # downstream price arithmetic then wraps mod 2^64 (observable in output)
    M64 = (1 << 64) - 1
    literals &= M64
    if literals > 0:
        s = max((common + literals) & M64, best_common)
    else:
        s = max(common, best_common)
    if off == last_off:
        off = 0
    if best_off == last_off:
        best_off = 0
    return (get_price_liz(ctx, last_off, src, ip, (s - common) & M64, off, common)
            <= get_price_liz(ctx, last_off, src, best_ip, (s - best_common) & M64, best_off, best_common))


def _find_match_lowest_price(ctx, src, tables, ip, ilimit):
    """Lizard_FindMatchLowestPrice (lizard_parser_lowestprice.h:29-122).
    Returns (ml, match_pos, is_rep)."""
    chain = tables.chain
    mask = (1 << ctx.params.content_log) - 1
    max_distance = (1 << ctx.params.window_log) - 1
    cur = ip + DICT
    low = DICT if DICT + max_distance >= cur else cur - max_distance
    mm_long = ctx.params.mm_long_off
    mi = tables.hash[_hash_pos(ctx, src, ip)]

    if ctx.last_off >= 8:
        ilo = cur - ctx.last_off
        if ilo >= low:
            m = ilo - DICT
            mlt = _count(src, ip, m, ilimit)
            if mlt > 1:  # REPMINMATCH
                return mlt, m, True

    attempts = ctx.params.search_num
    ml, pos = 0, -1
    while mi < cur and mi >= low and attempts:
        attempts -= 1
        m = mi - DICT
        if ip - m >= 8:
            if src[m + ml] == src[ip + ml] and _read32(src, m) == _read32(src, ip):
                mlt = _count(src, ip + MINMATCH, m + MINMATCH, ilimit) + MINMATCH
                if mlt >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                    if not ml or (mlt > ml and _better_price(
                            ctx, src, ip, ip - pos, ml, ip, ip - m, mlt, ctx.last_off)):
                        ml, pos = mlt, m
        mi -= chain[mi & mask]
    return ml, pos, False


def _get_wider_match_lp(ctx, src, tables, ip, ilow, ihigh, longest):
    """Lizard_GetWiderMatch (lizard_parser_lowestprice.h:125-251).
    Returns (longest, match_pos, start_pos)."""
    chain = tables.chain
    mask = (1 << ctx.params.content_log) - 1
    max_distance = (1 << ctx.params.window_log) - 1
    cur = ip + DICT
    low = DICT if DICT + max_distance >= cur else cur - max_distance
    mm_long = ctx.params.mm_long_off
    mi = tables.hash[_hash_pos(ctx, src, ip)]
    best = (longest, -1, -1)

    if ctx.last_off >= 8:
        ilo = cur - ctx.last_off
        if ilo >= low:
            m = ilo - DICT
            if _read32(src, m) == _read32(src, ip):
                back = 0
                mlt = _count(src, ip + MINMATCH, m + MINMATCH, ihigh) + MINMATCH
                while ip + back > ilow and m + back > 0 and src[ip + back - 1] == src[m + back - 1]:
                    back -= 1
                mlt -= back
                if mlt > best[0] and (mlt >= mm_long or ctx.last_off < LIZARD_MAX_16BIT_OFFSET):
                    best = (mlt, m + back, ip + back)

    attempts = ctx.params.search_num
    while mi < cur and mi >= low and attempts:
        attempts -= 1
        m = mi - DICT
        if ip - m >= 8 and _read32(src, m) == _read32(src, ip):
            back = 0
            mlt = _count(src, ip + MINMATCH, m + MINMATCH, ihigh) + MINMATCH
            while ip + back > ilow and m + back > 0 and src[ip + back - 1] == src[m + back - 1]:
                back -= 1
            mlt -= back
            if mlt >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                if not best[0] or (mlt > best[0] and _better_price(
                        ctx, src, best[2], best[2] - best[1], best[0],
                        ip, ip - m, mlt, ctx.last_off)):
                    best = (mlt, m + back, ip + back)
        mi -= chain[mi & mask]
    return best


def parse_lowestprice(ctx, src, start, end, tables):
    """Lizard_compress_lowestPrice (lizard_parser_lowestprice.h:256-375)."""
    anchor = start
    mflimit = end - MFLIMIT
    matchlimit = end - LASTLITERALS
    mm_long = ctx.params.mm_long_off
    sufficient = ctx.params.sufficient_length
    ip = start

    while ip < mflimit:
        insert_hc(ctx, src, tables, ip)
        ml, ref, is_rep = _find_match_lowest_price(ctx, src, tables, ip, matchlimit)
        if not ml:
            ip += 1
            continue

        back = 0
        while ip + back > anchor and ref + back > 0 and src[ip + back - 1] == src[ref + back - 1]:
            back -= 1
        ml -= back
        ip += back
        ref += back

        start0, ref0, ml0 = ip, ref, ml
        label = "search"

        while True:
            if label == "search":
                if ip + ml >= mflimit or ml >= sufficient:
                    label = "encode"
                    continue
                insert_hc(ctx, src, tables, ip)
                ml2, ref2, start2 = _get_wider_match_lp(ctx, src, tables,
                                                        ip + ml - 2, anchor,
                                                        matchlimit, 0)
                if not ml2:
                    label = "encode"
                    continue

                # choose split point with lowest modeled price
                # (lizard_parser_lowestprice.h:304-342)
                best_pos = ip
                best_price = MAX_PRICE
                off0 = ip - ref
                off1 = start2 - ref2
                pos = ip + ml
                while pos >= start2:
                    common0 = pos - ip
                    if common0 >= MINMATCH:
                        price = get_price_liz(ctx, ctx.last_off, src, ip, ip - anchor,
                                              0 if off0 == ctx.last_off else off0,
                                              common0)
                        common1 = start2 + ml2 - pos
                        if common1 >= MINMATCH:
                            price += get_price_liz(ctx, ctx.last_off, src, pos, 0,
                                                   0 if off1 == off0 else off1,
                                                   common1)
                        else:
                            price += get_price_liz(ctx, ctx.last_off, src, pos,
                                                   common1, 0, 0)
                        if price < best_price:
                            best_price = price
                            best_pos = pos
                    else:
                        price = get_price_liz(ctx, ctx.last_off, src, ip, start2 - anchor,
                                              0 if off1 == ctx.last_off else off1, ml2)
                        if price < best_price:
                            best_pos = pos
                        break
                    pos -= 1
                ml = best_pos - ip

                if ml < MINMATCH or (ml < mm_long and ip - ref >= LIZARD_MAX_16BIT_OFFSET):
                    ip, ref, ml = start2, ref2, ml2
                    label = "search"
                    continue
                label = "encode"
                continue

            # encode
            if start0 < ip:
                if _more_profitable(ctx, src, ip, ip - ref, ml, start0,
                                    start0 - ref0, ml0, ref0 - ref, ctx.last_off):
                    ip, ref, ml = start0, ref0, ml0
            match_arg = ip if (ip - ref == ctx.last_off) else ref
            ip, anchor = encode_seq_liz(ctx, src, anchor, ip, ml, match_arg)
            break

    encode_last_literals(ctx, src, anchor, end)
