"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` with a
plain C interface (loaded with ``ctypes``; no PyTorch headers, so a build
takes seconds, not minutes).  All sources compile in parallel, one ``nvcc``
process each, into ``sdfest_torch/_build/<hash>/``, keyed by a hash of the
sources, the shared header and the flags, so an edit rebuilds and an
unchanged tree reuses the libraries.  A missing ``nvcc`` or a failed build
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("march", "sample", "sample_grad", "scatter")
HEADERS = ("trilinear.cuh",)
# -fmad=false: every product and sum rounds on its own, as in the PyTorch
# versions the kernels are held against
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler messages (register and shared-memory use from ptxas) and the
# wall seconds of the last build, for reports
build_log: Dict[str, str] = {}
build_seconds: Optional[float] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in [f"{s}.cu" for s in SOURCES] + list(HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> Dict[str, str]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns ``{name: path}``.  Raises ``RuntimeError`` with the compiler's
    output when a build fails.
    """
    global build_seconds
    out_dir = os.path.join(BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    paths = {s: os.path.join(out_dir, f"lib{s}.so") for s in SOURCES}
    todo = [s for s in SOURCES if not os.path.exists(paths[s])]
    if not todo:
        return paths
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[s] = log
        if proc.returncode != 0:
            failed.append(f"--- {s}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, paths[s])
    build_seconds = time.perf_counter() - start
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build()[name])
        _LIBS[name] = lib
    return lib
