"""The benchmark's input corpus, made from the run's seed.

Frozen from lizard_tpu_torch/utils/datagen.py (`gen`, `text_like` and the
four-generator cycle of `build_corpus`) at commit
0be7bf655f3d0745fc3f06a33be719434c2ddeea, so that a later change to the
program cannot change what the benchmark feeds it. Three departures, all
for set-up time: `gen` draws its random numbers in bulk and writes its pieces
into one preallocated buffer (the same recipe: skewed literals, repeats of
the previous piece or, every 64 pieces, of the whole output so far; not the
same bytes), its literals are drawn from the distribution of a Zipf(1.3)
variate modulo the span by one table lookup each (numpy's zipf sampler
took most of the set-up), and `text_like` joins its words as bytes. Each
part takes its own generator seeded by (run seed, part index), so parts of one kind have
the same statistics under every seed.
"""

import functools

import numpy as np

_VOCAB = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
          b"lazy ", b"dog ", b"compression ", b"lizard ", b"stream ",
          b"block ", b"frame ", b"entropy ", b"huffman ", b"offset ",
          b"match ", b"literal ", b"a ", b"of ", b"and ", b"in ", b"to ",
          b"is ", b"was ", b"it "]


@functools.lru_cache(maxsize=None)
def _residue_cdf(a: float, span: int, terms: int = 1 << 20) -> np.ndarray:
    """The cumulative distribution of k % span for k ~ Zipf(a): the first
    `terms` values summed exactly, the tail (under 2% of the mass at
    a = 1.3) spread evenly over the residues."""
    k = np.arange(1, terms + 1, dtype=np.float64)
    w = k ** -a
    p = np.bincount((k % span).astype(np.int64), weights=w, minlength=span)
    tail = (terms + 0.5) ** (1 - a) / (a - 1)     # integral of the rest
    p = p + tail / span
    return np.cumsum(p / p.sum())


def gen(size: int, rng: np.random.Generator, proba: float = 0.70,
        lit_span: int = 130) -> bytes:
    """`size` bytes of LZ-friendly data: pieces that either repeat earlier
    output (with probability `proba`) or take fresh skewed literals."""
    cdf = _residue_cdf(1.3, lit_span)
    lits = (np.searchsorted(cdf, rng.random(max(size // 4, 1024)),
                            side="right") + 32).astype(np.uint8)
    n = size // 16 + 2                      # a piece is at least 16 bytes
    copy = (rng.random(n) < proba).tolist()
    seg = rng.integers(16, 2048, n).tolist()
    fresh = rng.integers(64, 1024, n).tolist()
    frac = rng.random(n).tolist()
    out = np.empty(size + 2048, np.uint8)
    out[:1024] = lits[:1024]
    total, prev, pieces = 1024, (0, 1024), 1
    i = 0
    while total < size:
        if copy[i]:
            a, b = prev
            src, lo, hi = (out, a, b) if b - a >= 512 else (lits, 0, lits.size)
            want = seg[i]
        else:
            src, lo, hi = lits, 0, lits.size
            want = fresh[i]
        start = lo + int(frac[i] * max(hi - lo - want, 1))
        m = min(want, hi - start)
        out[total:total + m] = src[start:start + m]
        prev = (total, total + m)
        total += m
        pieces += 1
        if pieces > 64:                     # matches may now reach far back
            prev, pieces = (0, total), 1
        i += 1
    return out[:size].tobytes()


def text_like(size: int, rng: np.random.Generator) -> bytes:
    """English-ish text: words of a small vocabulary in random order."""
    avg = sum(map(len, _VOCAB)) / len(_VOCAB)
    picks = rng.integers(0, len(_VOCAB), size=int(size / avg * 1.3) + 16)
    return b"".join([_VOCAB[p] for p in picks.tolist()])[:size]


_KINDS = {"gen": gen, "text_like": text_like}


def build(seed: int, total_bytes: int, part_bytes: int,
          kinds: list[dict]) -> bytes:
    """The corpus of a configuration: parts of `part_bytes` cycling through
    `kinds` (each {"gen": name, **parameters}), part k from the generator
    seeded by (seed, k)."""
    parts = []
    for k in range(-(-total_bytes // part_bytes)):
        spec = dict(kinds[k % len(kinds)])
        rng = np.random.default_rng([seed % (1 << 64), k])
        parts.append(_KINDS[spec.pop("gen")](part_bytes, rng, **spec))
    return b"".join(parts)[:total_bytes]
