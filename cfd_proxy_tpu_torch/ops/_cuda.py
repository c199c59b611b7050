"""Build and load the port's CUDA kernels (`csrc/*.cu`) for Hopper.

The sources have a plain C interface; `nvcc` compiles them for `sm_90a`
into one shared library under `cfd_proxy_tpu_torch/build/` (listed in
`.gitignore`), named by a hash of the sources and flags, so an edited source
rebuilds at its next use and an unchanged one loads as it is.  The library
is bound with `ctypes`: every pointer and the stream go through
`ctypes.c_void_p` (a bare Python int would be cut to 32 bits), and every
entry point returns its launch's `cudaError_t`.

Nothing here runs at import: the CPU tests import every module, and a
machine without a GPU usually has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache

from cfd_proxy_tpu.utils.errors import CheckError

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("pack_srcs.cu", "sweep_packed.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise CheckError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                     "the CUDA kernels are built on the machine with the GPU")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(force: bool = False) -> dict:
    """Compile the kernels unless a library for these exact sources exists.

    Returns {"path", "seconds", "built", "log"}: `log` holds nvcc's ptxas
    report (registers, shared memory, spills per kernel) of a fresh build.
    The library is written under a temporary name and renamed into place,
    so a concurrent build never loads a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libcfd_kernels-{_digest()}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path) and not force:
        return {"path": path, "seconds": 0.0, "built": False,
                "log": _read(log_path)}
    fd, tmp = tempfile.mkstemp(prefix=".build-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC_DIR, s) for s in SOURCES]]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise CheckError(f"nvcc failed (rc {res.returncode}):\n"
                             f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    with open(log_path, "w") as f:
        f.write(log)
    return {"path": path, "seconds": seconds, "built": True, "log": log}


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


@lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    L = ctypes.CDLL(build()["path"])
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    L.cfd_pack_srcs.restype = ctypes.c_int
    L.cfd_pack_srcs.argtypes = [vp, i64, vp, i64, i64, vp, vp]
    L.cfd_sweep_packed.restype = ctypes.c_int
    L.cfd_sweep_packed.argtypes = [vp, i64, vp, vp, vp, vp, vp, i32, i64,
                                   i64, i32, vp, vp]
    return L


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
