"""BENCHMARK.json keeps to the benchmark's contract, and a configuration,
a traffic mix or a metric added as a new file with a new entry is found by
name, with no file that is there edited."""

import hashlib
import json
import os
import re
import shutil

from h100_bench import harness
from h100_bench.tests import tiny

ROOT = os.path.dirname(tiny.BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return tiny.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_benchmark_json_keeps_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["h100_bench"]
    assert 1 <= s["run_seconds"] <= 51
    assert os.path.exists(os.path.join(ROOT, s["command"][1]))
    configs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/")
        cfg = tiny.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    cells = {w["name"]: w for w in s["workloads"]}
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert os.path.exists(os.path.join(
            tiny.BENCH, "traffic", w["traffic"] + ".json"))
        assert len(w["why"]) <= 200
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(tiny.BENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= set(cells)
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get(
            "workloads", cells))
    for name in cells:
        names = [m for m, _ in harness.resolve(name, False, ROOT)["metrics"]]
        assert "setup_s" in names and len(names) >= 2
        assert harness.resolve(name, True, ROOT)["metrics"]
    assert len(json.dumps(s)) <= 64 * 1024


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny.BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "h100_bench")
    bench = root / "h100_bench"
    cfg = tiny.load_json(bench / "configs" / "fastlz4-l10.json")
    cfg.update(name="liz-l21", level=21)
    (bench / "configs" / "liz-l21.json").write_text(json.dumps(cfg))
    traffic = tiny.load_json(bench / "traffic" / "decode_bulk.json")
    traffic.update(request_bytes=1 << 20)
    (bench / "traffic" / "decode_small.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "out_mb.py").write_text(
        "def read(run):\n    return run.out_bytes / 1e6\n")
    s = spec()
    s["configs"].append({"name": "liz-l21", "source": "x",
                         "file": "h100_bench/configs/liz-l21.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "l21-decode-small", "config": "liz-l21",
                           "traffic": "decode_small", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "out_mb", "unit": "MB", "better": "higher",
                           "source": "program_counter", "layer": "x",
                           "moves": "decode_gbps",
                           "workloads": ["l21-decode-small"]})
    s["end_to_end"][0]["workloads"].append("l21-decode-small")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = harness.resolve("l21-decode-small", True, str(root))
    assert cell["config"]["level"] == 21
    assert cell["traffic"]["request_bytes"] == 1 << 20
    assert cell["metrics"] == [("out_mb", "MB")]
    run = type("Run", (), {"out_bytes": 3e6})()
    assert harness.reader(cell["metric_dir"], "out_mb")(run) == 3.0
    e2e = harness.resolve("l21-decode-small", False, str(root))["metrics"]
    assert [m for m, _ in e2e] == ["decode_gbps", "setup_s"]
    after = _digest(root / "h100_bench")
    assert {k: after[k] for k in before} == before
