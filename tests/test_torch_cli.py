"""The port's command line (lizard_tpu_torch/cli.py) and tools
(lizard_tpu_torch/tools/) on the CPU (main's device="cpu": the plain
versions of the kernels): the cases of tests/test_cli.py, files crossing
between the two packages' CLIs both ways, LIZARD_TPU_BACKEND=ref writing
the JAX CLI's bytes, the backend values, -b, the argv0 modes; datagen_cli's
bytes equal to the JAX tool's and fullbench's rows. Bytes are exact."""

import os
import subprocess
import sys

import pytest

import lizard_tpu.cli as jcli
import lizard_tpu.tools.datagen_cli as jdatagen
from lizard_tpu.frame import decompress_frame as j_decompress_frame
from lizard_tpu.utils.datagen import gen
from lizard_tpu_torch import cli
from lizard_tpu_torch.frame import compress_frame, decompress_frame
from lizard_tpu_torch.tools import datagen_cli, fullbench
from tests.torch_cases import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def default_backend(monkeypatch):
    monkeypatch.delenv("LIZARD_TPU_BACKEND", raising=False)


def main(argv, **kw):
    return cli.main(argv, device="cpu", **kw)


def test_parse_level_digits():
    o = cli.parse_args(["-29", "-z", "file"])
    assert o.level == 29 and o.mode == "compress" and o.backend == "gpu"
    o = cli.parse_args(["-B5D", "file"])
    assert o.block_size_id == 5 and o.block_linked


def test_roundtrip_files(tmp_path):
    src = tmp_path / "data.bin"
    data = gen(50_000, 3)
    src.write_bytes(data)
    assert main(["-z", "-12", str(src)]) == 0
    liz = tmp_path / "data.bin.liz"
    assert j_decompress_frame(liz.read_bytes()) == data
    os.remove(src)
    assert main(["-d", str(liz)]) == 0
    assert src.read_bytes() == data


def test_test_mode(tmp_path):
    src = tmp_path / "x"
    src.write_bytes(gen(10_000, 1))
    main(["-z", str(src)])
    assert main(["-t", str(src) + ".liz"]) == 0


def test_no_overwrite(tmp_path):
    src = tmp_path / "y"
    src.write_bytes(b"hello world" * 100)
    main(["-z", str(src)])
    with pytest.raises(SystemExit):
        main(["-z", str(src)])
    assert main(["-z", "-f", str(src)]) == 0


def test_stdout_mode(tmp_path, capsysbinary):
    src = tmp_path / "z"
    data = gen(5_000, 2)
    src.write_bytes(data)
    main(["-z", "-c", str(src)])
    frame = capsysbinary.readouterr().out
    assert decompress_frame(frame, device="cpu") == data


def _run_cli(*args):
    """The port's CLI in a new process, on the CPU."""
    code = ("import sys; from lizard_tpu_torch.cli import main; "
            "sys.exit(main(sys.argv[1:], device='cpu'))")
    return subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, cwd=ROOT)


def test_truncated_frame_detected(tmp_path):
    """-t fails on a truncated frame, and on a truncated second frame after
    a complete one, with a non-zero exit (lizardio rejects unfinished
    streams)."""
    data = gen(100_000, seed=3, proba=0.7)
    frame = compress_frame(data, 11)
    bad = tmp_path / "bad.liz"
    bad.write_bytes(frame[:len(frame) // 2])
    r = _run_cli("-t", str(bad))
    assert r.returncode != 0 and b"truncated frame" in r.stderr
    bad.write_bytes(frame + frame[:len(frame) // 2])
    r = _run_cli("-t", str(bad))
    assert r.returncode != 0 and b"truncated frame" in r.stderr


def test_trailing_fragment_rejected(tmp_path):
    src = tmp_path / "w"
    src.write_bytes(gen(10_000, 4))
    main(["-z", str(src)])
    liz = tmp_path / "w.liz"
    liz.write_bytes(liz.read_bytes() + b"\x04\x22\x4d\x18\x40")  # 5-byte tail
    with pytest.raises(ValueError):
        main(["-t", str(liz)])
    with pytest.raises(ValueError):
        main(["-d", "-f", str(liz), str(tmp_path / "w.out")])


def test_passthrough_unknown_magic(tmp_path):
    raw = tmp_path / "notliz.liz"
    payload = b"PLAINDATA" * 100
    raw.write_bytes(payload)
    out = tmp_path / "notliz"
    with pytest.raises(SystemExit):
        main(["-d", str(raw), str(out)])
    with pytest.raises(SystemExit):
        main(["-t", "-f", str(raw)])
    assert main(["-d", "-f", str(raw), str(out)]) == 0
    assert out.read_bytes() == payload


def test_native_max_out_high_ratio(tmp_path, monkeypatch):
    """backend native: a frame compressing >256:1 decodes through the
    header-derived output bound."""
    src = tmp_path / "zeros"
    data = bytes(4 << 20)
    src.write_bytes(data)
    monkeypatch.setenv("LIZARD_TPU_BACKEND", "native")
    assert main(["-z", "-10", str(src)]) == 0
    os.remove(src)
    assert main(["-d", str(src) + ".liz"]) == 0
    assert src.read_bytes() == data


def test_chunked_roundtrip(tmp_path, monkeypatch):
    """700 KB through the 64 KB loops: compressed by the native backend,
    decoded by the default one (FrameDecoder on device="cpu")."""
    data = gen(700_000, 77, proba=0.6)
    src = tmp_path / "big.bin"
    src.write_bytes(data)
    monkeypatch.setenv("LIZARD_TPU_BACKEND", "native")
    assert main(["-z", "-12", "-f", str(src), str(tmp_path / "big.liz")]) == 0
    monkeypatch.delenv("LIZARD_TPU_BACKEND")
    assert main(["-d", "-f", str(tmp_path / "big.liz"),
                 str(tmp_path / "big.out")]) == 0
    assert (tmp_path / "big.out").read_bytes() == data


def test_sparse_writer(tmp_path):
    data = b"head" + bytes(1_000_000) + b"tail"
    src = tmp_path / "holes.bin"
    src.write_bytes(data)
    assert main(["-z", "-11", "-f", str(src)]) == 0
    out = tmp_path / "holes.out"
    assert main(["-d", "-f", str(src) + ".liz", str(out)]) == 0
    assert out.read_bytes() == data
    assert main(["-d", "-f", "--no-sparse", str(src) + ".liz",
                 str(out)]) == 0
    assert out.read_bytes() == data


def test_rm_removes_source(tmp_path):
    data = gen(10_000, 5, proba=0.6)
    src = tmp_path / "x.bin"
    src.write_bytes(data)
    assert main(["-z", "-11", "-f", "--rm", str(src)]) == 0
    assert not src.exists()
    liz = tmp_path / "x.bin.liz"
    assert main(["-d", "-f", "--rm", str(liz), str(tmp_path / "x.out")]) == 0
    assert not liz.exists()
    assert (tmp_path / "x.out").read_bytes() == data


def test_recursive(tmp_path):
    d = tmp_path / "dir" / "sub"
    d.mkdir(parents=True)
    files = {}
    for i in range(3):
        p = d / f"f{i}.bin"
        files[p] = gen(5_000 + i, i, proba=0.6)
        p.write_bytes(files[p])
    assert main(["-z", "-r", "-11", "-f", str(tmp_path / "dir")]) == 0
    for p, content in files.items():
        liz = p.with_name(p.name + ".liz")
        assert main(["-d", "-f", str(liz), str(p) + ".back"]) == 0
        assert (d / (p.name + ".back")).read_bytes() == content


def test_linked_streaming_roundtrip(tmp_path):
    """-BD compresses with the oracle (the card makes independent blocks
    only); the linked frame decodes on the card's path."""
    data = gen(300_000, 9, proba=0.5)
    src = tmp_path / "l.bin"
    src.write_bytes(data)
    assert main(["-z", "-12", "-B1", "-BD", "-f", str(src)]) == 0
    frame = (tmp_path / "l.bin.liz").read_bytes()
    assert frame[4] >> 5 & 1 == 0                   # linked blocks
    out = tmp_path / "l.out"
    assert main(["-d", "-f", str(src) + ".liz", str(out)]) == 0
    assert out.read_bytes() == data


def test_content_size_streaming(tmp_path):
    data = gen(50_000, 4, proba=0.6)
    src = tmp_path / "cs.bin"
    src.write_bytes(data)
    assert main(["-z", "-11", "--content-size", "-f", str(src)]) == 0
    out = tmp_path / "cs.out"
    assert main(["-d", "-f", str(src) + ".liz", str(out)]) == 0
    assert out.read_bytes() == data


@pytest.mark.parametrize("args", [["-12"], ["-21", "-B1", "-BD"],
                                  ["-41", "--content-size", "-B1"]],
                         ids=" ".join)
def test_files_cross_between_clis(tmp_path, monkeypatch, args):
    """A file compressed by the JAX CLI (its oracle) decodes with the
    port's, and one compressed by the port's CLI (the card's encoder,
    the oracle at -BD) decodes with the JAX one; with
    LIZARD_TPU_BACKEND=ref the port's CLI writes the JAX CLI's bytes."""
    data = gen(150_000, 12, proba=0.6)
    src = tmp_path / "a.bin"
    src.write_bytes(data)
    j, t, r = (tmp_path / n for n in ("j.liz", "t.liz", "r.liz"))
    assert jcli.main(["-z", "-q", *args, "-f", str(src), str(j)]) == 0
    assert main(["-z", "-q", *args, "-f", str(src), str(t)]) == 0
    assert main(["-d", "-q", "-f", str(j), str(tmp_path / "j.out")]) == 0
    assert jcli.main(["-d", "-q", "-f", str(t), str(tmp_path / "t.out")]) == 0
    assert (tmp_path / "j.out").read_bytes() == data
    assert (tmp_path / "t.out").read_bytes() == data
    monkeypatch.setenv("LIZARD_TPU_BACKEND", "ref")
    assert main(["-z", "-q", *args, "-f", str(src), str(r)]) == 0
    assert r.read_bytes() == j.read_bytes()
    assert main(["-t", "-q", str(r)]) == 0          # the oracle's decoder


def test_backend_values(tmp_path, monkeypatch):
    src = tmp_path / "b.bin"
    src.write_bytes(b"abc" * 100)
    monkeypatch.setenv("LIZARD_TPU_BACKEND", "lanes")
    with pytest.raises(SystemExit, match="gpu, native, ref"):
        main(["-z", str(src)])
    assert not (tmp_path / "b.bin.liz").exists()


@pytest.mark.parametrize("backend", ("gpu", "native", "ref"))
def test_bench(tmp_path, monkeypatch, capsys, backend):
    src = tmp_path / "bench.bin"
    src.write_bytes(gen(16_384, 8, proba=0.6))
    monkeypatch.setenv("LIZARD_TPU_BACKEND", backend)
    assert main(["-b11", "-e12", "-i1", str(src)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["-11", "-12"]


def test_argv0_modes(tmp_path, capsysbinary):
    src = tmp_path / "c.bin"
    data = gen(8_000, 6)
    src.write_bytes(data)
    main(["-z", "-q", str(src)])
    capsysbinary.readouterr()
    assert main([str(src) + ".liz"], prog="lizardcat") == 0
    assert capsysbinary.readouterr().out == data
    os.remove(src)
    assert main(["-q", str(src) + ".liz"], prog="unlizard") == 0
    assert src.read_bytes() == data


@pytest.mark.parametrize("argv", [[], ["-g10000", "-s3", "-P50"],
                                  ["-g2K", "-s7"]], ids=str)
def test_datagen_cli_equals_jax(capsysbinary, argv):
    assert datagen_cli.main(argv) == 0
    port = capsysbinary.readouterr().out
    assert jdatagen.main(argv) == 0
    assert port == capsysbinary.readouterr().out and port


def test_fullbench_rows(tmp_path, capsys):
    src = tmp_path / "fb.bin"
    src.write_bytes(gen(65_536, 3))
    assert fullbench.main(["-i1", str(src)], device="cpu") == 0
    rows = capsys.readouterr().out.splitlines()
    names = [r.rsplit(None, 2)[0] for r in rows]
    for name in ("Lizard_decompress -10 (cpu lanes)",
                 "Lizard_decompress -41 (cpu fused)",
                 "Lizard_compress -11 (cpu lanes)", "LizardF_decompress"):
        assert name in names
    assert all(float(r.split()[-2]) > 0 for r in rows)
