"""The host C++ geometry library: built with ``g++`` at first use, loaded
with ``ctypes``.

``src/sdfest_native.cpp`` (the port's own copy of the JAX package's source)
compiles into ``sdfest_torch/_build/native-<hash>/libsdfest_native.so``,
keyed by a hash of the source and the flags, so an edit rebuilds and an
unchanged tree reuses the library.  Nothing is built when the module is
imported.  A missing compiler or a failed build raises; nothing falls back.

Functions (numpy wrappers in :mod:`sdfest_torch.native.api`):

- ``voxelize_mesh``: triangle mesh -> signed distance grid;
- ``marching_tetrahedra``: isosurface triangle soup.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "sdfest_native.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_c_float_p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "voxelize_mesh": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _c_float_p]),
    "marching_tetrahedra": (ctypes.c_int, [
        _c_float_p, ctypes.c_int, ctypes.c_float, _c_float_p,
        ctypes.c_int]),
}

_lib: Optional[ctypes.CDLL] = None
# wall seconds of the last build in this process (None: none was needed)
build_seconds: Optional[float] = None


def library_path() -> str:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libsdfest_native.so")


def build() -> str:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    compiler = os.environ.get("CXX") or shutil.which("g++")
    if not compiler:
        raise RuntimeError("g++ not found: the host library cannot be built")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    start = time.perf_counter()
    proc = subprocess.run([compiler, *FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host library build failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - start
    return path


def load() -> ctypes.CDLL:
    """The loaded library (built on first use), its functions typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib
