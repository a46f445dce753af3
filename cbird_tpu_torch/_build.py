"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
for Hopper (``sm_90a``) into ``build/cbird_tpu_torch/`` beside the
package, at first use, then loaded with ctypes.  The library's file name
carries a hash of the source and of the local headers it includes
(``#include "..."``, such as ``csrc/sm90.cuh``), so an edited source or
header is rebuilt.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cbird_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise BuildError("nvcc not found (put it on PATH or set CUDA_HOME)")


def sources(name: str) -> list[str]:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    each once, in the order first met."""
    out, todo = [], [os.path.join(CSRC, f"{name}.cu")]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path) as f:
            todo += [os.path.join(os.path.dirname(path), inc)
                     for inc in _INCLUDE.findall(f.read())]
    return out


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists.
    @return the library path"""
    so = library_path(name)
    if os.path.exists(so):
        return so
    compiler = nvcc()  # raises before any file is made
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def load_all() -> list[str]:
    """Build every ``csrc/*.cu`` (one nvcc each, all at once) and load
    each.  @return the kernel sources' names"""
    names = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(CSRC, "*.cu")))
    with cf.ThreadPoolExecutor(max(1, len(names))) as ex:
        list(ex.map(build, names))
    for name in names:
        load(name)
    return names


def load_kernel(name: str, fn: str, argtypes: list) -> ctypes.CDLL:
    """Load library ``name`` and declare C function ``fn`` (returning a
    ``cudaError_t`` as int) and the shared ``cbird_error_string``."""
    lib = load(name)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    lib.cbird_error_string.argtypes = [ctypes.c_int]
    lib.cbird_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if err:
        msg = lib.cbird_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
