"""Optimal-price parser (optimalPrice / optimalPriceBT), replicating
lib/lizard_parser_optimal.h exactly (the port's copy of
lizard_tpu/ref/parser_optimal.py):

- candidate enumeration: Lizard_GetAllMatches (hash-chain, :60-176) or
  Lizard_BinTree_GetAllMatches (binary tree in chainTable, :181-320)
- DP over a LIZARD_OPT_NUM window with rep-offset tracking (:334-620)
- backward path reconstruction + forward encode (:623-667)

The opt[] state persists across outer iterations (the reference only zeroes
opt[0] per iteration); the DP sweep order guarantees every entry read was
written in the current iteration, so initial contents are immaterial.
"""

from lizard_tpu_torch.format.constants import (
    LASTLITERALS,
    LIZARD_MAX_16BIT_OFFSET,
    MFLIMIT,
    MINMATCH,
)
from lizard_tpu_torch.format.levels import Codewords, Parser
from lizard_tpu_torch.ref.block_encode import (
    DICT,
    _count,
    _read32,
    encode_last_literals,
    encode_seq_liz,
    encode_seq_lz4,
)
from lizard_tpu_torch.ref.parsers import _hash_pos, insert_hc
from lizard_tpu_torch.ref.price import get_price_liz, get_price_lz4

LIZARD_OPT_NUM = 1 << 12
REPMINMATCH = 1
MAX_PRICE = 1 << 28
MASK32 = 0xFFFFFFFF


def _get_price(ctx, src, rep, ip, lit_length, offset, match_length):
    if ctx.params.codewords == Codewords.LZ4:
        return get_price_lz4(ctx, src, ip, lit_length, offset, match_length)
    return get_price_liz(ctx, rep, src, ip, lit_length, offset, match_length)


def _get_all_matches(ctx, src, tables, ip, ilow, ihigh, best_mlen):
    """Lizard_GetAllMatches (lizard_parser_optimal.h:60-176).
    Returns list of (off, len, back)."""
    chain = tables.chain
    htab = tables.hash
    mask = (1 << ctx.params.content_log) - 1
    max_distance = (1 << ctx.params.window_log) - 1
    cur = ip + DICT
    low = DICT if DICT + max_distance >= cur else cur - max_distance
    mm_long = ctx.params.mm_long_off
    matches = []

    if ip + MINMATCH > ihigh:
        return matches

    h = _hash_pos(ctx, src, ip)
    mi = htab[h]
    chain[cur & mask] = (cur - mi) & MASK32
    htab[h] = cur
    tables.next_to_update += 1

    if best_mlen < MINMATCH - 1:
        best_mlen = MINMATCH - 1

    attempts = ctx.params.search_num
    while mi < cur and mi >= low and attempts:
        attempts -= 1
        m = mi - DICT
        if ip - m >= 8:
            if src[ip + best_mlen] == src[m + best_mlen] and _read32(src, m) == _read32(src, ip):
                back = 0
                mlt = _count(src, ip + MINMATCH, m + MINMATCH, ihigh) + MINMATCH
                while ip + back > ilow and m + back > 0 and src[ip + back - 1] == src[m + back - 1]:
                    back -= 1
                mlt -= back
                if mlt >= mm_long or ip - m < LIZARD_MAX_16BIT_OFFSET:
                    if mlt > best_mlen:
                        best_mlen = mlt
                        matches.append((ip - m, mlt, -back))
                        if best_mlen > LIZARD_OPT_NUM:
                            break
        mi -= chain[mi & mask]
    return matches


def _bt_get_all_matches(ctx, src, tables, ip, ihigh, best_mlen):
    """Lizard_BinTree_GetAllMatches (lizard_parser_optimal.h:181-320).
    The chainTable holds a binary search tree: two delta slots per position.
    Returns list of (off, len, back=0); relinks the tree as it walks."""
    chain = tables.chain
    htab = tables.hash
    mask = (1 << ctx.params.content_log) - 1
    max_distance = (1 << ctx.params.window_log) - 1
    cur = ip + DICT
    low = DICT if DICT + max_distance >= cur else cur - max_distance
    mm_long = ctx.params.mm_long_off
    matches = []

    if ip + MINMATCH > ihigh:
        return matches

    h = _hash_pos(ctx, src, ip)
    mi = htab[h]
    htab[h] = cur
    tables.next_to_update += 1

    # ptr0/ptr1 are chainTable slots, modeled as indices
    p0 = (cur * 2 + 1) & mask
    p1 = (cur * 2) & mask
    delta0 = delta1 = (cur - mi) & MASK32

    if best_mlen < MINMATCH - 1:
        best_mlen = MINMATCH - 1

    attempts = ctx.params.search_num
    while mi < cur and mi >= low and attempts:
        attempts -= 1
        m = mi - DICT
        mlt = _count(src, ip, m, ihigh)

        if (cur - mi) & MASK32 >= 8:
            if mlt >= mm_long or cur - mi < LIZARD_MAX_16BIT_OFFSET:
                if mlt > best_mlen:
                    best_mlen = mlt
                    matches.append((cur - mi, mlt, 0))
                    if mlt > LIZARD_OPT_NUM:
                        break
                    if ip + mlt >= ihigh:
                        break
        else:
            # offset < 8: synthesize a multiple-of-offset candidate
            newoff = 0
            while newoff < 8:
                newoff += cur - mi
            new_mi = cur - newoff
            newml = 0
            if new_mi >= DICT:
                newml = _count(src, ip, new_mi - DICT, ihigh)
            if newml >= mm_long and newml > best_mlen:
                best_mlen = newml
                matches.append((newoff, newml, 0))
                if newml > LIZARD_OPT_NUM:
                    break
                if ip + newml >= ihigh:
                    break

        # tree navigation + relink (reads at ip+mlt/m+mlt are in-bounds:
        # mlt is capped by ihigh = end-16)
        if src[ip + mlt] < src[m + mlt]:
            chain[p0] = delta0
            p0 = (mi * 2) & mask
            if chain[p0] == MASK32:
                break
            delta0 = chain[p0]
            delta1 = (delta1 + delta0) & MASK32
            mi -= delta0
        else:
            chain[p1] = delta1
            p1 = (mi * 2 + 1) & mask
            if chain[p1] == MASK32:
                break
            delta1 = chain[p1]
            delta0 = (delta0 + delta1) & MASK32
            mi -= delta1

    chain[p0] = MASK32
    chain[p1] = MASK32
    return matches


class _Opt:
    __slots__ = ("price", "off", "mlen", "litlen", "rep", "off24pos")

    def __init__(self):
        self.price = 0
        self.off = 0
        self.mlen = 0
        self.litlen = 0
        self.rep = 0
        self.off24pos = 0


def parse_optimal(ctx, src, start, end, tables):
    """Lizard_compress_optimalPrice (lizard_parser_optimal.h:334-678)."""
    opt = [_Opt() for _ in range(LIZARD_OPT_NUM + 4)]
    anchor = start
    mflimit = end - MFLIMIT
    matchlimit = end - LASTLITERALS
    max_distance = (1 << ctx.params.window_log) - 1
    sufficient = ctx.params.sufficient_length
    faster = ctx.params.full_search == 0
    mm_long = ctx.params.mm_long_off
    is_lz4 = ctx.params.codewords == Codewords.LZ4
    min_rep_off = (1 << 30) if is_lz4 else 8
    rep_min_match = MINMATCH if is_lz4 else REPMINMATCH
    use_bt = ctx.params.parser == Parser.OPTIMAL_PRICE_BT
    ip = start

    def set_price(pos, mlen, offset, litlen, price, last_pos):
        while last_pos < pos:
            opt[last_pos + 1].price = MAX_PRICE
            last_pos += 1
        o = opt[pos]
        o.mlen = mlen
        o.off = offset
        o.litlen = litlen
        o.price = price
        return last_pos

    def get_matches(pos, ilow, best_mlen):
        if use_bt:
            return _bt_get_all_matches(ctx, src, tables, pos, matchlimit, best_mlen)
        insert_hc(ctx, src, tables, pos)
        return _get_all_matches(ctx, src, tables, pos, ilow, matchlimit, best_mlen)

    while ip < mflimit:
        opt[0].price = 0
        opt[0].off = 0
        opt[0].mlen = 0
        opt[0].litlen = 0
        opt[0].rep = 0
        opt[0].off24pos = 0
        last_pos = 0
        llen = ip - anchor
        best_mlen = 0
        best_off = 0
        cur = 0
        do_encode = False

        # --- rep candidate at position 0 ---
        if ctx.last_off >= min_rep_off:
            ilo = ip + DICT - ctx.last_off
            mlen = 0
            if ilo >= DICT and ilo + max_distance >= ip + DICT:
                mlen = _count(src, ip, ilo - DICT, matchlimit)
            if mlen >= REPMINMATCH:
                if mlen > sufficient or mlen >= LIZARD_OPT_NUM:
                    best_mlen, best_off, cur, last_pos = mlen, 0, 0, 1
                    do_encode = True
                if not do_encode:
                    while mlen >= REPMINMATCH:
                        price = _get_price(ctx, src, ctx.last_off, ip, llen, 0, mlen)
                        if mlen > last_pos or price < opt[mlen].price:
                            last_pos = set_price(mlen, mlen, 0, 0, price, last_pos)
                        mlen -= 1

        if not do_encode:
            if faster and last_pos:
                matches = []
            else:
                matches = get_matches(ip, ip, last_pos)

            if not last_pos and not matches:
                ip += 1
                continue

            if matches and matches[-1][1] > sufficient:
                best_mlen = matches[-1][1]
                best_off = matches[-1][0]
                cur = 0
                last_pos = 1
                do_encode = True

        if not do_encode:
            # seed prices with matches at position 0
            best_mlen_seed = last_pos if last_pos > MINMATCH else MINMATCH
            prev_len = None
            for i, (moff, mlen_i, _mback) in enumerate(matches):
                mlen = prev_len + 1 if i > 0 else best_mlen_seed
                upper = mlen_i if mlen_i < LIZARD_OPT_NUM else LIZARD_OPT_NUM
                while mlen <= upper:
                    price = _get_price(ctx, src, ctx.last_off, ip, llen, moff, mlen)
                    if mlen >= mm_long or moff < LIZARD_MAX_16BIT_OFFSET:
                        if mlen > last_pos or price < opt[mlen].price:
                            last_pos = set_price(mlen, mlen, moff, 0, price, last_pos)
                    mlen += 1
                prev_len = mlen_i

            if last_pos < rep_min_match:
                ip += 1
                continue

            opt[0].off24pos = ctx.off24pos
            opt[0].rep = ctx.last_off
            opt[0].mlen = 1
            opt[0].off = -1

            # --- DP over further positions ---
            skip_num = 0
            cur = 1
            while cur <= last_pos:
                inr = ip + cur

                # literal extension into cur
                if opt[cur - 1].off == -1:
                    litlen = opt[cur - 1].litlen + 1
                    if cur != litlen:
                        price = opt[cur - litlen].price + _get_price(
                            ctx, src, opt[cur - litlen].rep, inr, litlen, 0, 0)
                    else:
                        price = _get_price(ctx, src, ctx.last_off, inr, llen + litlen, 0, 0)
                else:
                    litlen = 1
                    price = opt[cur - 1].price + _get_price(
                        ctx, src, opt[cur - 1].rep, inr, litlen, 0, 0)

                mlen = 1
                best_mlen = 0
                if cur > last_pos or price <= opt[cur].price:
                    last_pos = set_price(cur, 1, -1, litlen, price, last_pos)

                if cur == last_pos:
                    break

                # propagate rep state to cur
                if opt[cur].off != -1:
                    mlen2 = opt[cur].mlen
                    offset = opt[cur].off
                    if offset < 1:
                        opt[cur].rep = opt[cur - mlen2].rep
                        opt[cur].off24pos = opt[cur - mlen2].off24pos
                    else:
                        opt[cur].rep = offset
                        opt[cur].off24pos = (inr if offset >= LIZARD_MAX_16BIT_OFFSET
                                             else opt[cur - mlen2].off24pos)
                else:
                    opt[cur].rep = opt[cur - 1].rep
                    opt[cur].off24pos = opt[cur - 1].off24pos

                rep = opt[cur].rep

                # rep candidate at cur
                if opt[cur].rep >= min_rep_off:
                    ilo = inr + DICT - opt[cur].rep
                    mlen = 0
                    if ilo >= DICT and ilo + max_distance >= inr + DICT:
                        mlen = _count(src, inr, ilo - DICT, matchlimit)
                    if mlen >= REPMINMATCH:
                        if mlen > sufficient or cur + mlen >= LIZARD_OPT_NUM:
                            best_mlen = mlen
                            best_off = 0
                            last_pos = cur + 1
                            do_encode = True
                            break
                        best_mlen = mlen
                        if faster:
                            skip_num = best_mlen
                        while mlen >= REPMINMATCH:
                            if opt[cur].off == -1:
                                litlen = opt[cur].litlen
                                if cur != litlen:
                                    price = opt[cur - litlen].price + _get_price(
                                        ctx, src, rep, inr, litlen, 0, mlen)
                                else:
                                    price = _get_price(ctx, src, rep, inr,
                                                       llen + litlen, 0, mlen)
                            else:
                                litlen = 0
                                price = opt[cur].price + _get_price(
                                    ctx, src, rep, inr, litlen, 0, mlen)
                            if cur + mlen > last_pos or price <= opt[cur + mlen].price:
                                last_pos = set_price(cur + mlen, mlen, 0, litlen,
                                                     price, last_pos)
                            mlen -= 1

                if faster and skip_num > 0:
                    skip_num -= 1
                    cur += 1
                    continue

                matches = get_matches(inr, ip, best_mlen)

                if matches and matches[-1][1] > sufficient:
                    cur -= matches[-1][2]
                    best_mlen = matches[-1][1]
                    best_off = matches[-1][0]
                    last_pos = cur + 1
                    do_encode = True
                    break

                # seed prices with matches at cur
                best_mlen = best_mlen if best_mlen > MINMATCH else MINMATCH
                prev_len = None
                for i, (moff, mlen_i, mback) in enumerate(matches):
                    mlen = prev_len + 1 if i > 0 else best_mlen
                    cur2 = cur - mback
                    upper = (mlen_i if cur2 + mlen_i < LIZARD_OPT_NUM
                             else LIZARD_OPT_NUM - cur2)
                    if mlen < mback + 1:
                        mlen = mback + 1
                    while mlen <= upper:
                        if opt[cur2].off == -1:
                            litlen = opt[cur2].litlen
                            if cur2 != litlen:
                                price = opt[cur2 - litlen].price + _get_price(
                                    ctx, src, rep, inr, litlen, moff, mlen)
                            else:
                                price = _get_price(ctx, src, rep, inr,
                                                   llen + litlen, moff, mlen)
                        else:
                            litlen = 0
                            price = opt[cur2].price + _get_price(
                                ctx, src, rep, inr, litlen, moff, mlen)
                        if mlen >= mm_long or moff < LIZARD_MAX_16BIT_OFFSET:
                            if cur2 + mlen > last_pos or price < opt[cur2 + mlen].price:
                                last_pos = set_price(cur2 + mlen, mlen, moff,
                                                     litlen, price, last_pos)
                        mlen += 1
                    prev_len = mlen_i

                cur += 1

            if not do_encode:
                best_mlen = opt[last_pos].mlen
                best_off = opt[last_pos].off
                cur = last_pos - best_mlen

        # --- encode: backward path reconstruction ---
        opt[0].mlen = 1
        while True:
            mlen = opt[cur].mlen
            offset = opt[cur].off
            opt[cur].mlen = best_mlen
            opt[cur].off = best_off
            best_mlen = mlen
            best_off = offset
            if mlen > cur:
                break
            cur -= mlen

        cur = 0
        while cur < last_pos:
            mlen = opt[cur].mlen
            if opt[cur].off == -1:
                ip += 1
                cur += 1
                continue
            offset = opt[cur].off
            cur += mlen
            if is_lz4:
                ip, anchor = encode_seq_lz4(ctx, src, anchor, ip, mlen, ip - offset)
            else:
                ip, anchor = encode_seq_liz(ctx, src, anchor, ip, mlen, ip - offset)

    encode_last_literals(ctx, src, anchor, end)
