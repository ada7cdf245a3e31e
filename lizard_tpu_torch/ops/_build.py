"""Build and load the port's CUDA kernels (lizard_tpu_torch/csrc/*.cu).

Each source is compiled at first use, by nvcc alone, into a shared library
with a plain C interface that ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lizard_tpu_torch/lib<name>-<hash>.so
         lizard_tpu_torch/csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source builds anew. Sources build in parallel (one nvcc per source).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lizard_tpu_torch")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names: the csrc/*.cu files, without the suffix."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc() -> str:
    """nvcc on PATH, else under torch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: tried `nvcc` on PATH and "
        f"{cand or '$CUDA_HOME/bin/nvcc (torch found no CUDA_HOME)'}")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h[:16]}.so")


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc process each, all started together. Returns each name's
    compiler output (ptxas register and spill report); raises
    RuntimeError with the command and its output if one fails."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"   # two processes may build at once
            cmd = [nvcc(), *FLAGS, "-o", tmp, src]
            procs[name] = (cmd, tmp, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs, failed = {}, []
    for name, (cmd, tmp, so, p) in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{logs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(_target(name)[1])
    return lib
