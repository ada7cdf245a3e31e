#!/usr/bin/env python3
"""Time variants of huf_pack's kernels (lizard_tpu_torch/csrc/huf_encode.cu)
on one NVIDIA card, from the repo's root, to see where the time goes:

    python3 tools/huf_pack_variants.py

Each variant is the source with a few lines replaced (VARIANTS: a part of
the work taken out, or a constant changed), built with the port's nvcc
flags into build/lizard_tpu_torch/ (one nvcc each, all started together)
and launched through its C entry on the Huff0 batch of the encode path at
level 35 (chip_smoke.py phase 9: the 32 MB corpus of bench.py::
build_corpus in 256 x 128 KB blocks, its flags and literals streams
planned by enc_huf.plan_huf_streams). A variant that takes work out gives
wrong words; the line says whether each one's words, bits and status equal
huf_pack_plain's. Times: the device's time a call (BURST calls issued back
to back, median over REPS, two turns), the prep kernel's zeroing of the
words included. Also the same batch with its streams in descending order
of length under the unchanged kernel, and a memset of the same words
alone. Prints one line a variant, then one JSON line. Nothing in the
package imports this file.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "lizard_tpu_torch", "csrc", "huf_encode.cu")
BLOCK = 128 * 1024
CORPUS_BYTES = 32 << 20
LEVEL = 35
SYNTH_BYTES = (
    "  return {load_chunk(data, n_data, lo - m, seg_lo, seg_hi),\n"
    "          load_chunk(data, n_data, lo - m + 16, seg_lo, seg_hi)};",
    "  const uint32_t z = static_cast<uint32_t>(lo) * 2654435761u;\n"
    "  return {make_uint4(z, z ^ 0x5555u, z + 7, z >> 3),\n"
    "          make_uint4(z * 3, z ^ 0xAAAAu, z + 9, z >> 5)};")
SYNTH_ENTRIES = (
    "      e[i] = table[(x[b >> 2] >> (8 * (b & 3))) & 0xFFu];",
    "      e[i] = (6u << 16) | ((x[b >> 2] >> (8 * (b & 3))) & 0x3Fu);")
# name: [(text in the source, its replacement)]
VARIANTS = {
    "as_is": [],
    "no_loads": [SYNTH_BYTES],          # the symbols made up, not loaded
    "no_lookups": [SYNTH_ENTRIES],      # made-up 6-bit codes, no table
    "no_loads_no_lookups": [SYNTH_BYTES, SYNTH_ENTRIES],
    "no_pass_2": [(                     # counted, never packed
        "      int64_t wpos = pos + before;\n",
        "      int64_t wpos = pos + before;\n"
        "      if (len > 0) {\n        pos += total;\n        continue;\n"
        "      }\n")],
    "no_rounds": [(                     # set-up and the end mark's store
        "  for (int64_t r0 = 0; r0 < len; r0 += round) {",
        "  for (int64_t r0 = 0; r0 < len && len < 0; r0 += round) {")],
    "empty_blocks": [(                  # the blocks leave at once
        "  const int64_t hi = src_off + len;\n",
        "  if (len >= 0) {\n    if (tid == 0) status[seg] = 0;\n"
        "    return;\n  }\n  const int64_t hi = src_off + len;\n")],
    "row_order": [(                     # block b on row b
        "  const int64_t seg = order[blockIdx.x];",
        "  const int64_t seg = blockIdx.x;")],
    "blocks_256": [                     # 8 warps a segment, 4 blocks an SM
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 4;"),
        ("constexpr int kBufWords = 6144;",
         "constexpr int kBufWords = 11268;"),
        ("constexpr int kRoundSyms = 6016;",
         "constexpr int kRoundSyms = 8192;")],
}
REPS = 10
BURST = 20


def build(names_sources: dict) -> dict:
    """{name: ctypes function} of each variant source, one nvcc each, all
    started together; a build that fails raises."""
    from lizard_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, text in names_sources.items():
        src = os.path.join(_build.BUILD_DIR, f"huf_variant_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = src[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{out}")
        fn = ctypes.CDLL(so).huf_pack_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fns[name] = fn
    return fns


def variant(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"the source no longer holds {old!r} once")
        source = source.replace(old, new)
    return source


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("huf_pack_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from huf_pack_ab import burst_ms, huf_plan, smi_line
    from lizard_tpu_torch.ops import enc_huf as teh
    from lizard_tpu_torch.ops import enc_lanes as te
    from lizard_tpu_torch.utils.datagen import build_corpus

    with open(SRC) as f:
        source = f.read()
    fns = build({name: variant(source, edits)
                 for name, edits in VARIANTS.items()})
    corpus = build_corpus(CORPUS_BYTES)
    chunks = [corpus[i:i + BLOCK] for i in range(0, len(corpus), BLOCK)]
    a = huf_plan(te, teh, chunks, LEVEL).stage("cuda")
    data, segs, tables, n_words = (a["data"], a["segs"], a["tables"],
                                   a["n_words"])
    want = teh.huf_pack_plain(data, segs, tables, n_words)
    S = segs.shape[0]
    scratch = torch.empty(n_words + S, dtype=torch.int32, device="cuda")
    bits = torch.empty(S, dtype=torch.int64, device="cuda")
    status = torch.empty(S, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # the same plan, its streams in descending order of length
    order = torch.argsort(segs[:, 1].view(-1, 4).sum(1).cpu(),
                          descending=True)
    rows = segs.cpu().view(-1, 4, 4)[order].clone()
    rows[:, :, 2] = torch.arange(rows.shape[0])[:, None]
    sorted_args = (rows.view(-1, 4).contiguous().cuda(),
                   tables.cpu()[order].contiguous().cuda())

    def launcher(fn, rows_, tables_):
        def launch():
            err = fn(0, data.data_ptr(), data.numel(), rows_.data_ptr(), S,
                     tables_.data_ptr(), tables_.shape[0],
                     scratch.data_ptr(), n_words, bits.data_ptr(),
                     status.data_ptr(), None, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        return launch

    out = {}
    for turn in range(2):
        for name, fn in fns.items():
            launch = launcher(fn, segs, tables)
            if turn == 0:
                launch()
                torch.cuda.synchronize()
                equal = all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(
                    (scratch[:n_words], bits, status), want))
                print(f"{name}: words, bits and status equal to plain: "
                      f"{equal}", flush=True)
            out.setdefault(name, []).append(burst_ms(launch, REPS, BURST))
        out.setdefault("as_is_longest_streams_first", []).append(burst_ms(
            launcher(fns["as_is"], *sorted_args), REPS, BURST))
    words = torch.empty(n_words, dtype=torch.int32, device="cuda")
    print(json.dumps({"card": smi_line(), "level": LEVEL, "segments": S,
                      "device_ms_by_variant": out,
                      "memset_ms": burst_ms(words.zero_, REPS, BURST)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
