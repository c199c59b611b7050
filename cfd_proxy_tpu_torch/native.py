"""ctypes loader for the native host library (`native/*.cc` at the repo
root): the block-plan fast path, the partitioner's RCB and ghost closure,
and the C golden sweep.

The port's copy of `cfd_proxy_tpu/native/__init__.py` (the port imports
nothing of the JAX package).  It differs from the original in how the
library is built: the original runs `make -C native`, whose Makefile writes
the library into the JAX package; this loader compiles the same three
sources with `g++` itself, with the Makefile's flags, into
`cfd_proxy_tpu_torch/build/` (listed in `.gitignore`), under a name that
hashes the sources, the flags and the instruction set `-march=native`
resolves to on this host, so an edited source rebuilds at its next use and
a build directory carried to another CPU rebuilds instead of loading code
for a foreign ISA.
Concurrent builds (test workers) take a file lock; the library is renamed
into place, so no process loads a half-written file.

`lib()` returns None when the library cannot be built or loaded (no
compiler, `CFD_NATIVE=0`, a failed ABI handshake); every caller then keeps
its NumPy path, which computes the same thing.  This is host-side
preprocessing only: no device work depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from functools import lru_cache

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("prep.cc", "partition.cc", "golden.cc")
# native/Makefile's flags; golden.cc must NOT fuse mul+add: nthreads==1 is
# bit-gated against the NumPy golden (NumPy never emits FMA)
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
GOLDEN_FLAGS = ("-ffp-contract=off",)
LDLIBS = ("-lpthread",)
BUILD_TIMEOUT_S = 300

# Must match native/prep.cc::cfd_abi_version(): a library whose exported
# signatures differ from the declarations below fails the handshake in
# _bind and is not used.
_ABI_VERSION = 4


def _cxx() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def _flags(src: str) -> tuple[str, ...]:
    return CXXFLAGS + (GOLDEN_FLAGS if src == "golden.cc" else ())


def _target(cxx: str) -> bytes:
    """The target `-march=native` resolves to here, as the compiler reports
    it (its -march value and every ISA extension on or off)."""
    try:
        return subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True,
                              timeout=BUILD_TIMEOUT_S).stdout
    except (subprocess.SubprocessError, OSError):
        return platform.machine().encode()


def _so_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + GOLDEN_FLAGS + LDLIBS).encode())
    h.update(_target(cxx))
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcfdprep-{h.hexdigest()[:16]}.so")


def build() -> str | None:
    """Compile the library unless this exact build exists; returns its path,
    or None when there is no compiler or a compile fails."""
    import fcntl

    cxx = _cxx()
    if cxx is None or not all(os.path.exists(os.path.join(SRC_DIR, s))
                              for s in SOURCES):
        return None
    path = _so_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):             # built while we waited
            return path
        with tempfile.TemporaryDirectory(prefix=".native-",
                                         dir=BUILD_DIR) as tmp:
            objs = []
            try:
                for s in SOURCES:
                    o = os.path.join(tmp, s[:-3] + ".o")
                    subprocess.run([cxx, *_flags(s), "-c",
                                    os.path.join(SRC_DIR, s), "-o", o],
                                   check=True, capture_output=True,
                                   timeout=BUILD_TIMEOUT_S)
                    objs.append(o)
                lib_tmp = os.path.join(tmp, "lib.so")
                subprocess.run([cxx, "-shared", *objs, "-o", lib_tmp,
                                *LDLIBS], check=True, capture_output=True,
                               timeout=BUILD_TIMEOUT_S)
            except (subprocess.SubprocessError, OSError):
                return None
            os.replace(lib_tmp, path)
    return path


@lru_cache(maxsize=1)
def lib():
    if os.environ.get("CFD_NATIVE", "1") == "0":
        return None
    path = build()
    return None if path is None else _bind(path)


def _bind(path):
    try:
        L = ctypes.CDLL(path)
    except OSError:
        return None
    try:
        _declare(L)
    except AttributeError:
        return None
    if L.cfd_abi_version() != _ABI_VERSION:
        return None
    return L


def _declare(L):
    L.cfd_abi_version.restype = ctypes.c_int
    L.cfd_abi_version.argtypes = []
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    L.cfd_plan_sizes.restype = ctypes.c_int
    L.cfd_plan_sizes.argtypes = [
        i32p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64,
        i32p, i32p, u8p,
    ]
    L.cfd_plan_fill.restype = ctypes.c_int
    L.cfd_plan_fill.argtypes = [
        i32p, ctypes.c_int64, f64p, u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p, i32p, f32p,
        i32p, i32p,
    ]
    L.cfd_golden_gg.restype = ctypes.c_int
    L.cfd_golden_gg.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int64, f64p,
        f64p, ctypes.c_int32,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    L.cfd_rcb_assign.restype = ctypes.c_int
    L.cfd_rcb_assign.argtypes = [f64p, ctypes.c_int64, ctypes.c_int32, i32p]
    L.cfd_ghosts_run.restype = ctypes.c_void_p
    L.cfd_ghosts_run.argtypes = [
        i32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i64p, i64p,
    ]
    L.cfd_ghosts_take.restype = ctypes.c_int
    L.cfd_ghosts_take.argtypes = [
        ctypes.c_void_p, i64p, i64p, i32p, i8p, i32p,
    ]


def rcb_assign_c(coords, npart: int):
    """Native recursive coordinate bisection, or None if unavailable.

    Same membership as the NumPy path for tie-free coordinates; ties at a
    cut are broken by (value, global id) — see native/partition.cc."""
    import numpy as np

    L = lib()
    if L is None:
        return None
    coords_c = np.ascontiguousarray(coords, np.float64)
    owner = np.zeros(coords_c.shape[0], np.int32)
    rc = L.cfd_rcb_assign(ptr(coords_c, ctypes.c_double), coords_c.shape[0],
                          int(npart), ptr(owner, ctypes.c_int32))
    return owner if rc == 0 else None


def ghost_closure_c(faces, owner, npart: int, ghost_layers: int):
    """Native sparse ghost closure (native/partition.cc) or None.

    Returns (ghost_gid, ghost_depth, goff, face_ids, foff): per-partition
    ghost points in BFS order + kept-face ids ascending, with prefix offsets.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    faces_c = np.ascontiguousarray(faces, np.int32)
    owner_c = np.ascontiguousarray(owner, np.int32)
    F, N = faces_c.shape[0], owner_c.shape[0]
    ng = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    handle = L.cfd_ghosts_run(
        ptr(faces_c, ctypes.c_int32), F, ptr(owner_c, ctypes.c_int32), N,
        npart, ghost_layers, ctypes.byref(ng), ctypes.byref(nf),
    )
    if not handle:
        return None
    goff = np.zeros(npart + 1, np.int64)
    foff = np.zeros(npart + 1, np.int64)
    ghost_gid = np.zeros(ng.value, np.int32)
    ghost_depth = np.zeros(ng.value, np.int8)
    face_ids = np.zeros(nf.value, np.int32)
    rc = L.cfd_ghosts_take(
        handle, ptr(goff, ctypes.c_int64), ptr(foff, ctypes.c_int64),
        ptr(ghost_gid, ctypes.c_int32), ptr(ghost_depth, ctypes.c_int8),
        ptr(face_ids, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return ghost_gid, ghost_depth, goff, face_ids, foff


def golden_gg_c(var, faces, normals, nthreads: int = 1,
                validate: bool = True):
    """C golden sweep (native/golden.cc) or None if the library is absent.

    nthreads==1 is bit-identical to ops/golden.py::compute_gradients_gg;
    threaded mode is the multi-core CPU-baseline denominator (not bit-gated).

    validate=True (default) checks face endpoints in [0, npoint) here,
    vectorised, and returns None on a bad mesh (np.add.at would raise); the C
    function itself does not scan.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    var_c = np.ascontiguousarray(var, np.float64)
    faces_c = np.ascontiguousarray(faces, np.int32)
    normals_c = np.ascontiguousarray(normals, np.float64)
    npoint, nvar = var_c.shape
    if validate and faces_c.size and (
            faces_c.min() < 0 or faces_c.max() >= npoint):
        return None
    grad = np.zeros((npoint, nvar, 3), np.float64)
    rc = L.cfd_golden_gg(
        ptr(var_c, ctypes.c_double), npoint, nvar,
        ptr(faces_c, ctypes.c_int32), faces_c.shape[0],
        ptr(normals_c, ctypes.c_double), ptr(grad, ctypes.c_double),
        int(nthreads),
    )
    if rc != 0:
        return None
    return grad


def ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
