"""The port (lizard_tpu_torch) stands alone, and its copied modules equal the
JAX package's: constants, the level table, xxh32, the data generators, the
native runtime binding."""

import ast
import enum
import os
import subprocess
import sys

import pytest

import lizard_tpu.format.constants as jconst
import lizard_tpu.format.levels as jlevels
import lizard_tpu.runtime as jrt
import lizard_tpu.utils.datagen as jgen
import lizard_tpu.utils.xxh as jxxh
import lizard_tpu_torch.format.constants as tconst
import lizard_tpu_torch.format.levels as tlevels
import lizard_tpu_torch.runtime as trt
import lizard_tpu_torch.utils.datagen as tgen
import lizard_tpu_torch.utils.xxh as txxh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lizard_tpu_torch")


def test_import_pulls_in_no_jax():
    code = ("import sys, lizard_tpu_torch, lizard_tpu_torch.frame, "
            "lizard_tpu_torch.ops.lane_decode, lizard_tpu_torch.ops.fuse, "
            "lizard_tpu_torch.ops.enc_lanes, lizard_tpu_torch.ops.lane_huf, "
            "lizard_tpu_torch.ops.pallas_decode, lizard_tpu_torch.ops.decode, "
            "lizard_tpu_torch.ops.encode_tpu, "
            "lizard_tpu_torch.parallel.pipeline, "
            "lizard_tpu_torch.parallel.multihost, "
            "lizard_tpu_torch.utils.profiling, lizard_tpu_torch.entry, "
            "lizard_tpu_torch.streaming, lizard_tpu_torch.cli, "
            "lizard_tpu_torch.tools.fullbench, "
            "lizard_tpu_torch.tools.datagen_cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lizard_tpu')]; print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports_in_package_or_chip_smoke():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_cases.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lizard_tpu", "bench"), (f, mod)


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def test_constants_equal_reference():
    ref, port = _public(jconst), _public(tconst)
    assert ref.keys() == port.keys()
    for k in ref:
        assert port[k] == ref[k], k
    for fn in ("minimal_huff_gain", "minimal_block_gain", "compress_bound"):
        for n in (0, 1, 1000, 1 << 20):
            assert getattr(tconst, fn)(n) == getattr(jconst, fn)(n)


def test_levels_equal_reference():
    assert tlevels.LEVELS.keys() == jlevels.LEVELS.keys()
    fields = [f for f in jlevels.LevelParams.__dataclass_fields__]
    for lv, ref in jlevels.LEVELS.items():
        port = tlevels.LEVELS[lv]
        for f in fields:
            a, b = getattr(ref, f), getattr(port, f)
            if isinstance(a, enum.Enum):
                a, b = a.value, b.value
            assert a == b, (lv, f)
        assert tlevels.uses_huffman(lv) == jlevels.uses_huffman(lv)
    for lv in (-3, 0, 9, 10, 33, 49, 50, 99):
        assert tlevels.validate_level(lv) == jlevels.validate_level(lv)


def test_xxh32_and_native_binding_equal_reference():
    data = jgen.gen(50_000, seed=9)
    for seed in (0, 7):
        assert txxh.xxh32(data, seed) == jxxh.xxh32(data, seed)
        assert trt.xxh32(data, seed) == jxxh.xxh32(data, seed)
    h = txxh.XXH32(3)
    h.update(data[:333]).update(data[333:])
    assert h.digest() == jxxh.xxh32(data, 3)
    for level in (10, 21, 35, 41):
        comp = trt.compress(data, level)
        assert comp == jrt.compress(data, level)
        assert trt.decompress(comp, len(data)) == data
    with pytest.raises(ValueError):
        trt.compress(data, 9)


def test_datagen_and_corpus_equal_reference():
    for seed in (0, 5):
        assert tgen.gen(70_000, seed, proba=0.4) == jgen.gen(70_000, seed, proba=0.4)
        assert tgen.text_like(70_000, seed) == jgen.text_like(70_000, seed)
    import bench
    n = (8 << 20) + 12345      # three 4 MB parts, cut
    assert tgen.build_corpus(n) == bench.build_corpus(n)


def test_realfiles_corpus_equals_reference(monkeypatch, tmp_path):
    import sysconfig

    import bench
    stdlib = sysconfig.get_paths()["stdlib"]
    monkeypatch.setenv("BENCH_REALFILES_DIR", stdlib)
    n = (2 << 20) + 777
    got = tgen.build_corpus_realfiles(n)
    assert len(got) == n
    assert got == bench.build_corpus_realfiles(n)
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "y").write_bytes(b"yy")
    (tmp_path / "a").write_bytes(b"x")
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "z").write_bytes(b"z")
    monkeypatch.setenv("BENCH_REALFILES_DIR", str(tmp_path))
    assert tgen.build_corpus_realfiles(99, [str(tmp_path)]) == b"xzyy" \
        == bench.build_corpus_realfiles(99)
    assert tgen.build_corpus_realfiles(9, [str(tmp_path / "none")]) is None
