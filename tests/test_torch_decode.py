"""The port's all-XLA decoder (lizard_tpu_torch/ops/decode.py) against the
JAX package's (lizard_tpu/ops/decode.py) on the same streams, on the CPU:
per-token arrays, decoded bytes and per-block lengths exactly equal
(tolerance 0), at levels of all four families."""

import functools

import jax
import numpy as np
import pytest
import torch

from lizard_tpu.ops import decode as J
from lizard_tpu.ops import split as JS
from lizard_tpu_torch import api, runtime
from lizard_tpu_torch.ops import decode as P
from lizard_tpu_torch.ops import split as PS
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import gen, text_like
from tests.torch_cases import one_thread  # noqa: F401

PAD_ROWS = 2        # padded rows (flags_len = -1), as JAX's sharded paths add


def _cases():
    """The inputs of tests/test_jax_decode.py: each one stream of the
    batch, the 300 KB one crossing inner blocks."""
    return [
        gen(20_000, 2),
        text_like(30_000, 4),
        bytes(4000),
        np.random.default_rng(9).integers(0, 256, 5000).astype(
            np.uint8).tobytes(),
        gen(300_000, 3),
        b"abcd" * 6,
        b"",
    ]


@functools.partial(jax.jit, static_argnames=(
    "total_out", "max_steps", "max_tokens_total", "family_liz"))
def _jax_decode(flags, lit, off16, off24, flags_off, flags_len, lit_off,
                lit_len, off16_off, off24_off, total_out, max_steps,
                max_tokens_total, family_liz):
    """The JAX decode_batch's step, with the per-token arrays returned."""
    if family_liz:
        parsed = J.token_parse_liz(flags, lit, off16, off24, flags_off,
                                   flags_len, lit_off, lit_len, off16_off,
                                   off24_off, max_steps)
    else:
        parsed = J.token_parse_lz4(flags, lit, flags_off, flags_len,
                                   lit_off, lit_len, max_steps)
    return (*parsed, *J.resolve_output(*parsed, flags_len, lit, total_out,
                                       max_tokens_total))


def _padded_arrays(batch):
    """The JAX batch's arrays as decode_batch stages them, with PAD_ROWS
    rows of flags_len = -1 after the real ones."""
    streams = [np.concatenate([getattr(batch, k),
                               np.zeros(J.GUARD, np.uint8)])
               for k in ("flags", "literals", "off16", "off24")]
    table = [np.concatenate([getattr(batch, k), np.full(
        PAD_ROWS, -1 if k == "flags_len" else 0, np.int32)])
        for k in P.TABLE]
    return streams + table


@pytest.mark.parametrize("level", [10, 17, 21, 29, 35, 45])
def test_decode_equals_jax(level):
    """Token parse (padded rows included), resolve and decode_batch on one
    multi-stream batch of the cases."""
    datas = _cases()
    streams = [runtime.compress(d, level) for d in datas]
    acc, family = JS.new_accumulator(), None
    for i, s in enumerate(streams):
        family = JS.split_stream(s, acc, i)
    jb = JS.finalize(acc, family)
    total = sum(map(len, datas))
    max_steps = jb.max_tokens
    max_tokens_total = int((jb.flags_len + 1).sum())
    arrays = _padded_arrays(jb)
    liz = level // 10 in (2, 4)
    want = [np.asarray(a) for a in _jax_decode(
        *arrays, total_out=total, max_steps=max_steps,
        max_tokens_total=max_tokens_total, family_liz=liz)]

    t = [torch.from_numpy(a.astype(np.uint8 if i < 4 else np.int64))
         for i, a in enumerate(arrays)]
    if liz:
        parsed = P.token_parse_liz(*t, max_steps)
    else:
        parsed = P.token_parse_lz4(t[0], t[1], *t[4:8], max_steps)
    got = [*parsed, *P.resolve_output(*parsed, t[5], t[1], total,
                                      max_tokens_total)]
    for name, w, g in zip(("ll", "ml", "off", "lit_start", "out", "blk_len"),
                          want, got):
        assert np.array_equal(g.numpy(), w), name
    assert not got[0][-PAD_ROWS:].any() and not got[3][-PAD_ROWS:].any()

    pacc, pfam = PS.new_accumulator(), None
    for i, s in enumerate(streams):
        pfam = PS.split_stream(s, pacc, i)
    out, blk_len = P.decode_batch(PS.finalize(pacc, pfam), total,
                                  device="cpu")
    assert bytes(out.numpy()) == bytes(want[4]) == b"".join(datas)
    assert np.array_equal(blk_len.numpy(), want[5][:-PAD_ROWS])


@pytest.mark.parametrize("level", [12, 25])
def test_decompress_xla_equals_jax(level):
    """One stream through decompress_xla and api.decompress(backend="xla")
    as through decompress_jax; a max_out below the decoded size cuts the
    output there, as in JAX."""
    d = gen(20_000, 7, proba=0.6)
    s = runtime.compress(d, level)
    assert P.decompress_xla(s, len(d), device="cpu") == d
    assert api.decompress(s, len(d), device="cpu", backend="xla") == d
    short = len(d) - 1000
    assert (P.decompress_xla(s, short, device="cpu")
            == J.decompress_jax(s, short) == d[:short])
    with pytest.raises(ValueError):
        P.decompress_xla(s, device="cpu")
    with pytest.raises(NotImplementedError):
        api.decompress(s, len(d), device="cpu", backend="jax")


def test_mixed_family_batch_raises():
    acc = PS.new_accumulator()
    PS.split_stream(runtime.compress(gen(3000, 1), 12), acc, 0)
    PS.split_stream(runtime.compress(gen(3000, 2), 22), acc, 1)
    with pytest.raises(ValueError, match="one codeword family"):
        P.decode_batch(PS.finalize(acc, None), 6000, device="cpu")


def test_profiling_trace_and_stages(tmp_path):
    """utils/profiling.py: a torch.profiler trace of a decode step written
    to the directory with the step's span in it, the span recorded while
    the profiler ran (and not after it), and the report of the spans."""
    profiling.reset()
    s = runtime.compress(gen(5000, 3), 12)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("decode", "host"):
            P.decompress_xla(s, 5000, device="cpu")
    with profiling.span("decode", "host"):
        pass
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any(e.key == "lizard.decode" for e in prof.key_averages())
    roots = [r for r in profiling.records() if r.parent is None]
    assert [r.name for r in roots] == ["decode"]
    assert "decode" in profiling.report(reset_after=True)
    assert profiling.records() == []
