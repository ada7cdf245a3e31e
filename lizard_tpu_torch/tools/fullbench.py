"""Per-function micro-benchmarks, the equivalent of tests/fullbench.c (the
port of lizard_tpu/tools/fullbench.py): times each public codec function
alone (doubling as an API-coverage smoke test), fastest of -i runs, in MB/s
of input. `python -m lizard_tpu_torch.tools.fullbench [-i iters] [file]`
(256 KB of utils/datagen.py::gen without a file).

Besides the host rows (the oracle, the native library, frames, hashes,
Huff0), three rows run on `device` (main's argument: the card unless
device="cpu", which runs the kernels' plain versions) on the input's
128 KB chunks: decompress_lanes at -10 (lz_decode), the fused route at -41
(huf_decode then lz_decode) and encode_blocks_lanes at -11 on the first 8
chunks (match_find, parse_tokens). They always run; they synchronise the
device before the clock stops."""

import sys
import time


def _time(fn, iters):
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    iters = 3
    path = None
    i = 0
    while i < len(argv):
        if argv[i] == "-i":
            iters = int(argv[i + 1]); i += 2
        elif argv[i].startswith("-i"):
            iters = int(argv[i][2:]); i += 1
        else:
            path = argv[i]; i += 1

    import torch

    from lizard_tpu_torch import runtime
    from lizard_tpu_torch.device import resolve_device
    from lizard_tpu_torch.frame import compress_frame, decompress_frame
    from lizard_tpu_torch.ops.enc_lanes import encode_blocks_lanes
    from lizard_tpu_torch.ops.lane_decode import decompress_lanes
    from lizard_tpu_torch.ref.block_decode import decompress as py_decompress
    from lizard_tpu_torch.ref.block_encode import compress
    from lizard_tpu_torch.ref.huf import huf_decompress
    from lizard_tpu_torch.ref.huf_encode import huf_compress
    from lizard_tpu_torch.utils.datagen import gen
    from lizard_tpu_torch.utils.xxh import xxh32, xxh64

    dev = resolve_device(device)
    data = open(path, "rb").read() if path else gen(256 * 1024, 0)
    n = len(data)

    rows = []

    def bench(name, fn, size=n):
        dt = _time(fn, iters)
        rows.append((name, size / dt / 1e6))

    def on_device(fn):
        def run():
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return run

    comp10 = compress(data, 10)
    comp31 = compress(data, 31)
    bench("Lizard_compress -10 (oracle)", lambda: compress(data, 10))
    bench("Lizard_compress -21 (oracle)", lambda: compress(data, 21))
    bench("Lizard_decompress -10 (oracle)", lambda: py_decompress(comp10, n))
    bench("Lizard_decompress -10 (native)",
          lambda: runtime.decompress(comp10, n))
    bench("Lizard_decompress -31 (native)",
          lambda: runtime.decompress(comp31, n))
    frame = compress_frame(data, 11)
    bench("LizardF_compressFrame -11", lambda: compress_frame(data, 11))
    bench("LizardF_decompress", on_device(
        lambda: decompress_frame(frame, device=dev)))
    bench("XXH32", lambda: xxh32(data))
    bench("XXH64", lambda: xxh64(data))
    bench("XXH32 (native)", lambda: runtime.xxh32(data))
    bench("Lizard_compress -11 (native C++)",
          lambda: runtime.compress(data, 11))
    # the kernels on the device: 128 KB independent blocks
    chunks = [data[i:i + 131072] for i in range(0, n, 131072)]
    streams10 = [compress(c, 10) for c in chunks]
    decompress_lanes(streams10, device=dev)          # build, first launch
    bench(f"Lizard_decompress -10 ({dev.type} lanes)", on_device(
        lambda: decompress_lanes(streams10, device=dev)))
    streams41 = [compress(c, 41) for c in chunks]
    decompress_lanes(streams41, device=dev)
    bench(f"Lizard_decompress -41 ({dev.type} fused)", on_device(
        lambda: decompress_lanes(streams41, device=dev)))
    encode_blocks_lanes(chunks[:8], level=11, device=dev)
    bench(f"Lizard_compress -11 ({dev.type} lanes)", on_device(
        lambda: encode_blocks_lanes(chunks[:8], level=11, device=dev)),
        sum(len(c) for c in chunks[:8]))
    hc = huf_compress(data[:128 * 1024])
    if hc:
        bench("HUF_compress", lambda: huf_compress(data[:128 * 1024]),
              min(n, 128 * 1024))
        bench("HUF_decompress", lambda: huf_decompress(hc, min(n, 128 * 1024)),
              min(n, 128 * 1024))

    width = max(len(r[0]) for r in rows)
    for name, mbps in rows:
        print(f"{name:<{width}}  {mbps:10.2f} MB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
