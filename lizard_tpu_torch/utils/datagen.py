"""Deterministic compressible-data generator (a copy of
lizard_tpu/utils/datagen.py) and the decode benchmark's corpora (copies of
bench.py::build_corpus and build_corpus_realfiles), so that the port makes
the same bytes from the same seeds without importing the JAX package.

Equivalent in role to the reference's programs/datagen.c (RDG): seeded,
tunable redundancy, skewed literal distribution. Vectorized (numpy) so
multi-MB corpora are cheap. Not bit-identical to RDG."""

import os
import sysconfig

import numpy as np


def gen(size: int, seed: int = 0, proba: float = 0.70, lit_span: int = 130) -> bytes:
    """Generate `size` bytes; `proba` controls how much of the output comes
    from repeats of earlier material (higher => more compressible)."""
    rng = np.random.default_rng(seed)
    # skewed literal base material
    lits = ((rng.zipf(1.3, size=max(size // 4, 1024)) % lit_span) + 32).astype(np.uint8)

    out = [lits[:1024]]
    total = 1024
    while total < size:
        if rng.random() < proba:
            # copy a segment from recent output (windowed match)
            src = out[-1] if len(out[-1]) >= 512 else lits
            seg_len = int(rng.integers(16, 2048))
            start = int(rng.integers(0, max(len(src) - seg_len, 1)))
            piece = src[start:start + seg_len]
        else:
            n = int(rng.integers(64, 1024))
            start = int(rng.integers(0, max(len(lits) - n, 1)))
            piece = lits[start:start + n]
        out.append(piece)
        total += len(piece)
        # periodically consolidate so matches can reach far back
        if len(out) > 64:
            out = [np.concatenate(out)]
    return np.concatenate(out).tobytes()[:size]


def text_like(size: int, seed: int = 0) -> bytes:
    """English-ish text: repeated vocabulary, vectorized construction."""
    rng = np.random.default_rng(seed)
    vocab = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
             b"lazy ", b"dog ", b"compression ", b"lizard ", b"stream ",
             b"block ", b"frame ", b"entropy ", b"huffman ", b"offset ",
             b"match ", b"literal ", b"a ", b"of ", b"and ", b"in ", b"to ",
             b"is ", b"was ", b"it "]
    arr = np.frombuffer(b"".join(vocab), dtype=np.uint8)
    offs = np.cumsum([0] + [len(v) for v in vocab])
    avg = arr.size / len(vocab)
    picks = rng.integers(0, len(vocab), size=int(size / avg * 1.3) + 16)
    # gather word spans
    starts = offs[picks]
    lens = offs[picks + 1] - starts
    total = int(lens.sum())
    idx = np.repeat(starts + lens - lens, lens)  # starts repeated per byte
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    data = arr[idx + within]
    return data.tobytes()[:size]


def build_corpus(n_bytes: int) -> bytes:
    """The decode benchmark's synthetic mixed-compressibility corpus
    (bench.py::build_corpus): 4 MB parts cycling through four generators,
    seeds 0, 1, 2, ..."""
    parts = []
    seed = 0
    per = 4 << 20
    kinds = [lambda s: gen(per, s, proba=0.70),
             lambda s: text_like(per, s),
             lambda s: gen(per, s, proba=0.40),
             lambda s: gen(per, s, proba=0.55, lit_span=60)]
    while sum(map(len, parts)) < n_bytes:
        parts.append(kinds[seed % len(kinds)](seed))
        seed += 1
    return b"".join(parts)[:n_bytes]


def build_corpus_realfiles(n_bytes: int, roots=None) -> bytes | None:
    """The benchmark's real-file corpus (bench.py::build_corpus_realfiles):
    a deterministic concatenation (sorted walk, tar spirit) of the files
    under `roots`, by default the Python standard library's sources (real
    code and text), cut at n_bytes. Files under `__pycache__` count too,
    as in bench.py, whose pruning of them runs after sorted() has walked
    the whole tree and so prunes nothing. None when no root exists or
    holds a file; shorter than n_bytes when the roots hold less."""
    if roots is None:
        roots = [sysconfig.get_paths()["stdlib"]]
    parts, total = [], 0
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, _, filenames in sorted(os.walk(root)):
            for fn in sorted(filenames):
                try:
                    with open(os.path.join(dirpath, fn), "rb") as f:
                        b = f.read()
                except OSError:
                    continue
                parts.append(b)
                total += len(b)
                if total >= n_bytes:
                    return b"".join(parts)[:n_bytes]
    data = b"".join(parts)
    return data if data else None
