"""Build and load the port's CUDA kernels (`csrc/*.cu`) for Hopper.

The sources have a plain C interface; `nvcc` compiles each one for `sm_90a`
into an object (all compiles started together) and links them into one
shared library under `cfd_proxy_tpu_torch/build/` (listed in `.gitignore`),
named by a hash of the sources, headers and flags, so an edited file
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

from cfd_proxy_tpu_torch.utils.errors import CheckError

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("pack_srcs.cu", "sweep_packed.cu", "sweep_gather.cu",
           "sweep_overlap.cu", "kbench_twins.cu", "kbench_rungs.cu",
           "push_bench.cu", "ipc.cu")
HEADERS = ("sweep_common.cuh", "push_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600


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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; raise on the first that
    failed.  Returns their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], None
    for c, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (c, p.returncode, out)
    if failed is not None:
        c, rc, out = failed
        raise CheckError(f"nvcc failed (rc {rc}):\n{' '.join(c)}\n{out}")
    return "".join(outs)


def build(force: bool = False) -> dict:
    """Compile the kernels unless a library for these exact sources exists.

    Returns {"path", "seconds", "built", "log"}: `log` holds nvcc's ptxas
    report (registers, shared memory, spills per kernel) of a fresh build.
    The objects and the library are written under a temporary directory and
    the library is renamed into place, so a concurrent build never loads a
    half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libcfd_kernels-{_digest()}.so")
    log_path = path[:-3] + ".log"
    if os.path.exists(path) and not force:
        return {"path": path, "seconds": 0.0, "built": False,
                "log": _read(log_path)}
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".build-", dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s[:-3] + ".o") for s in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o,
                         os.path.join(CSRC_DIR, s)]
                        for s, o in zip(SOURCES, objs)])
        lib_tmp = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, path)
    seconds = time.perf_counter() - t0
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
    # pack: var_T, ndev, widx, ext_idx, ep, block_ids, slots, K, bp, P, nb,
    # L, delta, rows, out, stream
    L.cfd_pack_srcs.restype = ctypes.c_int
    L.cfd_pack_srcs.argtypes = [vp, i64, vp, vp, i32, vp, vp, i32, i32, i64,
                                i64, i64, i32, i32, vp, vp]
    sweep = [vp, i64, vp, vp, vp, vp, vp, i32, i64, i64, i64, i32]
    # gather: var_T, ndev, exts, ep, slot_idx, slot_w, scale, block_ids,
    # slots, K, P, nb, bp, ext_cnt, the body (blocksweep.GATHER_BODY_CODES)
    gather = [vp, i64, vp, i64, vp, vp, vp, vp, vp, i32, i64, i64, i32, vp,
              i32]
    # sendbufs, esize, dsts, nph, s_max, recv, stream
    push = [vp, i32, vp, i64, i64, vp, vp]
    # the peer form's: sendbufs, esize, table, flags, recv, nph, s_max,
    # mode, stream (the launch epochs are device words after `flags`)
    peer = [vp, i32, vp, vp, vp, i64, i64, i32, vp]
    # (accumulate,) op (0 gg, 1 flux), then the dtype flags: w_bf16,
    # (packed: src_bf16d,) out_bf16, (K1 alone: var_bf16,) and out
    for name, args in (
            ("cfd_sweep_packed", [*sweep, i32, i32, i32, i32, i32, i32, vp,
                                  vp]),
            ("cfd_sweep_overlap", [*sweep, i32, i32, i32, i32, vp, *push]),
            # the gather forms: the cluster body's threads
            ("cfd_sweep_gather", [*gather, i32, i32, i32, i32, i32, vp, vp]),
            ("cfd_sweep_overlap_gather", [*gather, i32, i32, i32, i32, vp,
                                          *push]),
            ("cfd_sweep_overlap_peer", [*sweep, i32, i32, i32, i32, vp,
                                        *peer]),
            ("cfd_sweep_overlap_gather_peer", [*gather, i32, i32, i32, i32,
                                               vp, *peer]),
            # K6: sendbufs, P, nph, bytes, table, flags, recv, mode, stream
            ("cfd_push_phases", [vp, i64, i64, i64, vp, vp, vp, i32, vp]),
            # kernel facts (registers, local bytes, static shared bytes,
            # blocks per SM; the cluster bodies also their resident
            # clusters) into an int[5]: K3-peer (gather, w_bf16, src_bf16d,
            # out_bf16), K6 (none), K4 (delta, smem), K2 (body, accumulate,
            # op, w_bf16, out_bf16, smem, threads), K3's gather form (peer,
            # body, op, w_bf16, out_bf16, smem, threads)
            ("cfd_overlap_peer_info", [i32, i32, i32, i32, vp]),
            ("cfd_sweep_gather_info", [i32, i32, i32, i32, i32, i32, i32,
                                       vp]),
            ("cfd_overlap_gather_info", [i32, i32, i32, i32, i32, i32,
                                         i32, vp]),
            ("cfd_push_phases_info", [vp]),
            ("cfd_pack_srcs_info", [i32, i32, vp]),
            # mapped exchange memory (csrc/ipc.cu): device first
            ("cfd_ipc_alloc", [i32, i64, ctypes.POINTER(vp)]),
            ("cfd_ipc_free", [i32, vp]),
            ("cfd_ipc_export", [vp, ctypes.c_char_p]),
            ("cfd_ipc_open", [i32, ctypes.c_char_p, ctypes.POINTER(vp)]),
            ("cfd_ipc_close", [i32, vp]),
            # the kbench twins (ops/twins.py): the packed sweep's operands,
            # (stream: bf16,) out, stream
            ("cfd_stream_twin", [*sweep, i32, vp, vp]),
            ("cfd_wsum_twin", [*sweep, vp, vp]),
            ("cfd_nv7_sweep", [*sweep, vp, vp]),
            # the bench's rungs: rung (its index in twins.RUNGS), extra
            # (wsum or i8_scale, else null), out, stream
            ("cfd_kbench_rung", [*sweep, i32, vp, vp, vp])):
        fn = getattr(L, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return L


def kernel_info(name: str, *args: int) -> dict:
    """Registers and local bytes per thread, static shared bytes and
    resident blocks per SM of a kernel instance, as the CUDA runtime
    reports them: `name` one of "cfd_overlap_peer_info",
    "cfd_push_phases_info", "cfd_pack_srcs_info", "cfd_sweep_gather_info"
    or "cfd_overlap_gather_info" (the last two also give `active_clusters`:
    the clusters of the cluster body that can be resident at once, 0 for
    the other bodies), args as it takes them."""
    out = (ctypes.c_int * 5)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    check_launch(getattr(lib(), name)(*args, ptr), name)
    keys = ("regs", "local_bytes", "static_smem", "blocks_per_sm")
    if name in ("cfd_sweep_gather_info", "cfd_overlap_gather_info"):
        keys += ("active_clusters",)
    return dict(zip(keys, out))


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
