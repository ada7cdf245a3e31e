"""Nothing under h100_bench/ imports JAX or the JAX package (module names
compared whole by their first part, so lizard_tpu_torch is not taken for
lizard_tpu), nothing under h100_bench/reference/ imports the program or
anything outside that folder, and no module names the JAX package's
benchmark files."""

import ast
import os

import pytest

from h100_bench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "lizard_tpu"}


def modules():
    for d, _, files in os.walk(tiny.BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), tiny.BENCH)


def imported(path):
    with open(os.path.join(tiny.BENCH, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def strings(path):
    with open(os.path.join(tiny.BENCH, path)) as f:
        tree = ast.parse(f.read())
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_the_check_compares_whole_names():
    top = {n.split(".")[0] for n in ["lizard_tpu_torch.api", "jax.numpy"]}
    assert top & FORBIDDEN == {"jax"}


@pytest.mark.parametrize("path", list(modules()))
def test_no_jax_and_a_standalone_reference(path):
    names = list(imported(path))
    assert not {n.split(".")[0] for n in names} & FORBIDDEN
    if path.startswith("reference" + os.sep):
        assert all(n.split(".")[0] != "lizard_tpu_torch" for n in names)
        assert all(n.startswith("h100_bench.reference") or
                   n.split(".")[0] not in ("h100_bench",) for n in names)
    if path != os.path.join("tests", "test_bench_imports.py"):
        for s in strings(path):
            assert "bench.py" not in s and "BENCH_" not in s
            assert "lizard_tpu/" not in s


@pytest.mark.parametrize("name", sorted(os.listdir(
    os.path.join(tiny.BENCH, "traffic"))))
def test_traffic_calls_the_port(name):
    entry = tiny.load_json(os.path.join(tiny.BENCH, "traffic", name))["entry"]
    assert entry.split(".")[0] == "lizard_tpu_torch"
