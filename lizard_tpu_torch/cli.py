"""`lizard`-compatible command line interface (programs/lizardcli.c:239-581),
the port of lizard_tpu/cli.py: the same options and the same 64 KB loop.

Supported surface:
  lizard [arg] [input] [output]
  -z / -d / -t        force compress / decompress / test
  -1 .. -9, -10..-49  compression level (digits aggregate like the reference)
  -f                  overwrite output
  -c                  write to stdout
  -k                  keep source (default; present for compatibility)
  -B1..-B7            frame block size id
  -BD                 linked blocks
  --no-frame-crc      disable content checksum
  --content-size      store uncompressed size in frame header
  -m                  multiple input files
  -r                  recurse directories (implies -m)
  --rm                remove source file(s) after successful operation
  --no-sparse         disable the sparse file writer
  -v / -q             verbosity up / down
  -b# [-e#] [-i#]     in-memory benchmark of level(s) on the input files
  argv0 `lizardcat` => decompress to stdout; `unlizard` => decompress

Decompress auto-detects legacy pass-through and skippable frames; `.liz` is
the default suffix. Files stream through in 64 KB chunks in bounded memory
(lizardio.c:647-698); decompressed zero runs become holes via the sparse
writer (lizardio.c:533-604) unless --no-sparse.

LIZARD_TPU_BACKEND selects the codec: `gpu` (the default) compresses with
frame.FrameEncoder(backend="gpu") and decompresses with frame.FrameDecoder,
both on the card (main's device="cpu" runs their plain versions); -BD
compresses with the oracle (FrameEncoder(backend="ref")), since the card
makes independent blocks only. `native` compresses independent blocks with
the C++ encoder and decompresses a whole file with the native frame
decoder; `ref` is the oracle both ways. Any other value exits with a
message. A failure exits non-zero: no backend falls back to another.
"""

import os
import sys
import time

from lizard_tpu_torch import runtime
from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.format.constants import (
    LIZARD_DEFAULT_CLEVEL, LIZARDF_MAGIC, LIZARDF_MAGIC_SKIPPABLE_START)
from lizard_tpu_torch.frame import (
    FrameDecoder, FrameEncoder, decoded_size_bound)

LIZARD_EXTENSION = ".liz"
BACKENDS = ("gpu", "native", "ref")


class Options:
    def __init__(self):
        self.mode = "auto"          # auto | compress | decompress | test | bench
        self.level = 1
        self.block_size_id = 4      # CLI default -B4 (lizardcli.c:62)
        self.block_linked = False
        self.frame_crc = True
        self.content_size = False
        self.overwrite = False
        self.stdout = False
        self.multiple = False
        self.recursive = False
        self.remove_src = False
        self.sparse = True
        self.verbosity = 2
        self.bench_level_end = 0
        self.bench_iters = 3
        self.inputs = []
        self.output = None
        self.backend = os.environ.get("LIZARD_TPU_BACKEND", "gpu")
        self.device = None          # main's device: None is the card


def _log(opts, lvl, msg):
    if opts.verbosity >= lvl:
        print(msg, file=sys.stderr)


def parse_args(argv, prog="lizard"):
    opts = Options()
    if prog.endswith("lizardcat"):
        opts.mode = "decompress"
        opts.stdout = True
        opts.verbosity = 1
    elif prog.endswith("unlizard"):
        opts.mode = "decompress"

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--no-frame-crc":
            opts.frame_crc = False
        elif arg == "--content-size":
            opts.content_size = True
        elif arg == "--rm":
            opts.remove_src = True
        elif arg == "--no-sparse":
            opts.sparse = False
        elif arg == "--help" or arg == "-h":
            print(__doc__)
            sys.exit(0)
        elif arg.startswith("-") and len(arg) > 1:
            j = 1
            while j < len(arg):
                c = arg[j]
                if c.isdigit():
                    # digits aggregate: -29 == level 29 (lizardcli.c:300)
                    lv = 0
                    while j < len(arg) and arg[j].isdigit():
                        lv = lv * 10 + int(arg[j])
                        j += 1
                    opts.level = lv
                    continue
                if c == "z":
                    opts.mode = "compress"
                elif c == "d":
                    opts.mode = "decompress"
                elif c == "t":
                    opts.mode = "test"
                elif c == "f":
                    opts.overwrite = True
                elif c == "c":
                    opts.stdout = True
                    opts.verbosity = 1
                elif c == "k":
                    pass
                elif c == "m":
                    opts.multiple = True
                elif c == "r":
                    opts.recursive = True
                    opts.multiple = True
                elif c == "v":
                    opts.verbosity += 1
                elif c == "q":
                    opts.verbosity -= 1
                elif c == "B":
                    j += 1
                    while j < len(arg):
                        if arg[j] == "D":
                            opts.block_linked = True
                            j += 1
                        elif arg[j].isdigit():
                            opts.block_size_id = int(arg[j])
                            j += 1
                        else:
                            break
                    continue
                elif c == "b":
                    opts.mode = "bench"
                    j += 1
                    lv = 0
                    while j < len(arg) and arg[j].isdigit():
                        lv = lv * 10 + int(arg[j])
                        j += 1
                    if lv:
                        opts.level = lv
                    continue
                elif c == "e":
                    j += 1
                    lv = 0
                    while j < len(arg) and arg[j].isdigit():
                        lv = lv * 10 + int(arg[j])
                        j += 1
                    opts.bench_level_end = lv
                    continue
                elif c == "i":
                    j += 1
                    it = 0
                    while j < len(arg) and arg[j].isdigit():
                        it = it * 10 + int(arg[j])
                        j += 1
                    opts.bench_iters = max(it, 1)
                    continue
                else:
                    raise SystemExit(f"lizard: unknown option -{c}")
                j += 1
        else:
            opts.inputs.append(arg)
        i += 1

    if not opts.multiple and len(opts.inputs) > 1:
        opts.output = opts.inputs.pop()
    return opts


IO_CHUNK = 64 * 1024         # lizardio.c:647 (64 KB read granularity)
SPARSE_SEG = 32 * 1024       # sparse-detection granularity (lizardio.c:540)


class _SparseWriter:
    """Sparse-file writer (lizardio.c:533-604 role): zero segments become
    seeks (filesystem holes); close() materializes the final size when the
    output ends in zeros."""

    def __init__(self, f, enabled: bool):
        self.f = f
        self.enabled = enabled and f.seekable()
        self.pending = 0

    def write(self, buf: bytes) -> None:
        if not self.enabled:
            self.f.write(buf)
            return
        for i in range(0, len(buf), SPARSE_SEG):
            seg = buf[i:i + SPARSE_SEG]
            if seg.count(0) == len(seg):
                self.pending += len(seg)
            else:
                if self.pending:
                    self.f.seek(self.pending, 1)
                    self.pending = 0
                self.f.write(seg)

    def close(self) -> None:
        if self.pending:
            self.f.seek(self.pending - 1, 1)
            self.f.write(b"\0")
            self.pending = 0


def _open_dst(opts, dst_path):
    if opts.stdout or dst_path == "-":
        return sys.stdout.buffer, False
    if os.path.exists(dst_path) and not opts.overwrite:
        raise SystemExit(f"lizard: {dst_path} already exists; use -f")
    return open(dst_path, "wb"), True


def _finish_file(opts, src_path, dst_path, close_dst):
    if close_dst and src_path != "-":
        st = os.stat(src_path)
        os.utime(dst_path, (st.st_atime, st.st_mtime))
    if opts.remove_src and src_path != "-" and not opts.stdout:
        os.unlink(src_path)


def _do_file_compress(opts, src_path):
    dst_path = opts.output or (src_path + LIZARD_EXTENSION)
    level = (opts.level if opts.level >= 10 else 10 * opts.level
             if opts.level else LIZARD_DEFAULT_CLEVEL)
    src = sys.stdin.buffer if src_path == "-" else open(src_path, "rb")
    content_size = None
    if opts.content_size:
        if src_path == "-":
            raise SystemExit("lizard: --content-size needs a seekable input")
        content_size = os.stat(src_path).st_size

    backend = "ref" if opts.block_linked else opts.backend
    enc = FrameEncoder(level=level, block_size_id=opts.block_size_id,
                       block_linked=opts.block_linked,
                       content_checksum=opts.frame_crc,
                       content_size=content_size, backend=backend,
                       device=opts.device)
    dst, close_dst = _open_dst(opts, dst_path)
    t0 = time.time()
    n_in = n_out = 0
    try:
        buf = enc.begin()
        dst.write(buf)
        n_out += len(buf)
        while True:
            chunk = src.read(IO_CHUNK)
            if not chunk:
                break
            n_in += len(chunk)
            buf = enc.update(chunk)
            dst.write(buf)
            n_out += len(buf)
        buf = enc.end()
        dst.write(buf)
        n_out += len(buf)
    finally:
        if src_path != "-":
            src.close()
        if close_dst:
            dst.close()
    _finish_file(opts, src_path, dst_path, close_dst)
    dt = time.time() - t0
    ratio = 100.0 * n_out / n_in if n_in else 0.0
    _log(opts, 2, f"Compressed {n_in} bytes into {n_out} bytes "
                  f"==> {ratio:.2f}% ({dt:.2f}s)")


def _do_file_decompress(opts, src_path, test_only=False):
    if src_path == "-":
        src = sys.stdin.buffer
        dst_path = opts.output or "-"
    else:
        src = open(src_path, "rb")
        if opts.output:
            dst_path = opts.output
        elif src_path.endswith(LIZARD_EXTENSION):
            dst_path = src_path[:-len(LIZARD_EXTENSION)]
        else:
            dst_path = src_path + ".out"

    # Magic dispatch (lizardio.c:743-788): unrecognized leading magic is
    # passed through unchanged when -f and not test mode, else rejected.
    head = src.read(4)
    magic = int.from_bytes(head, "little") if len(head) == 4 else -1
    passthrough = head and (
        magic != LIZARDF_MAGIC
        and (magic & 0xFFFFFFF0) != LIZARDF_MAGIC_SKIPPABLE_START)
    if passthrough and (test_only or not opts.overwrite):
        if src_path != "-":
            src.close()
        raise SystemExit(
            f"lizard: {src_path}: unrecognized header, file cannot be "
            f"decoded (use -df to pass through unknown formats)")
    if passthrough:
        _log(opts, 3, f"{src_path}: unknown format, passing through")

    # backend "native": whole-buffer path (the C++ frame decoder)
    if not passthrough and not test_only and opts.backend == "native":
        data = head + src.read()
        if src_path != "-":
            src.close()
        out = runtime.decompress_frame(data,
                                       max_out=decoded_size_bound(data))
        dst, close_dst = _open_dst(opts, dst_path)
        dst.write(out)
        if close_dst:
            dst.close()
        _finish_file(opts, src_path, dst_path, close_dst)
        _log(opts, 2, f"Decompressed {len(out)} bytes from {src_path}")
        return

    # default: 64 KB chunked loop in bounded memory (lizardio.c:647-698)
    dec = None if passthrough else FrameDecoder(
        device=opts.device, backend="gpu" if opts.backend == "gpu" else "ref")
    dst = writer = close_dst = None
    if not test_only:
        dst, close_dst = _open_dst(opts, dst_path)
        writer = _SparseWriter(dst, opts.sparse and close_dst)
    n_out = 0
    got_any = bool(head)
    try:
        chunk = head
        while chunk:
            if passthrough:
                out = chunk
            else:
                out = dec.update(chunk)
            n_out += len(out)
            if writer is not None and out:
                writer.write(out)
            chunk = src.read(IO_CHUNK)
        # any unconsumed bytes (a mid-frame truncation or a trailing
        # fragment shorter than a next-frame header) mean the file is not
        # a clean sequence of complete frames (lizardio.c:783-786 warns)
        if dec is not None and (len(dec.buf) or (not dec.finished and got_any)):
            raise ValueError("truncated frame: unfinished stream")
    finally:
        if src_path != "-":
            src.close()
        if writer is not None:
            writer.close()
        if close_dst:
            dst.close()
    if test_only:
        _log(opts, 2, f"{src_path}: decoded {n_out} bytes")
        return
    _finish_file(opts, src_path, dst_path, close_dst)
    _log(opts, 2, f"Decompressed {n_out} bytes from {src_path}")


def _do_bench(opts):
    """In-memory benchmark, programs/bench.c protocol (fastest of N,
    xxh64-verified round-trip) of the selected backend: `gpu` times
    api.compress and api.decompress on the card (or main's device),
    `native` the C++ encoder and decoder, `ref` the oracle."""
    from lizard_tpu_torch import api
    from lizard_tpu_torch.utils.datagen import gen

    if opts.backend == "native":
        def comp_fn(data, level):
            return runtime.compress(data, level)

        def decomp_fn(comp, n):
            return runtime.decompress(comp, max_out=n)
    else:
        kw = ({"device": resolve_device(opts.device)}
              if opts.backend == "gpu" else {})

        def comp_fn(data, level):
            return api.compress(data, level, backend=opts.backend, **kw)

        def decomp_fn(comp, n):
            return api.decompress(comp, max_out=n, backend=opts.backend,
                                  **kw)
    datas = ([open(p, "rb").read() for p in opts.inputs]
             if opts.inputs else [gen(1 << 20, seed=0)])
    lv_end = max(opts.bench_level_end, opts.level)
    for level in range(opts.level, lv_end + 1):
        for data in datas:
            csize, cbest, dbest = None, float("inf"), float("inf")
            for _ in range(opts.bench_iters):
                t0 = time.perf_counter()
                comp = comp_fn(data, level)
                cbest = min(cbest, time.perf_counter() - t0)
                t0 = time.perf_counter()
                out = decomp_fn(comp, len(data))
                dbest = min(dbest, time.perf_counter() - t0)
                csize = len(comp)
                if runtime.xxh64(out) != runtime.xxh64(data):
                    raise ValueError("round-trip mismatch!")
            print(f"-{level:2d} {len(data):>10} -> {csize:>10} "
                  f"({100.0*csize/max(len(data),1):6.2f}%) "
                  f"{len(data)/cbest/1e6:8.1f} MB/s {len(data)/dbest/1e6:8.1f} MB/s")


def main(argv=None, prog=None, device=None):
    """Run the command line `argv` (default sys.argv[1:]); `device` is
    where the gpu backend runs (None: the card; "cpu": the plain
    versions). Returns 0; a failure raises (SystemExit with a message for
    a usage error), so the program exits non-zero."""
    argv = sys.argv[1:] if argv is None else argv
    prog = prog or os.path.basename(sys.argv[0] if sys.argv else "lizard")
    opts = parse_args(argv, prog)
    if opts.backend not in BACKENDS:
        raise SystemExit(f"lizard: LIZARD_TPU_BACKEND={opts.backend!r}: "
                         f"use one of {', '.join(BACKENDS)}")
    opts.device = device

    if opts.mode == "bench":
        _do_bench(opts)
        return 0

    inputs = opts.inputs or ["-"]
    if opts.recursive:
        expanded = []
        for p in inputs:
            if os.path.isdir(p):
                for root, _dirs, files in os.walk(p):
                    expanded.extend(os.path.join(root, f)
                                    for f in sorted(files))
            else:
                expanded.append(p)
        inputs = expanded
    for src in inputs:
        if opts.mode == "compress":
            _do_file_compress(opts, src)
        elif opts.mode == "decompress":
            _do_file_decompress(opts, src)
        elif opts.mode == "test":
            _do_file_decompress(opts, src, test_only=True)
        else:  # auto: decompress if .liz else compress
            if src.endswith(LIZARD_EXTENSION):
                _do_file_decompress(opts, src)
            else:
                _do_file_compress(opts, src)
    return 0


if __name__ == "__main__":
    sys.exit(main())
