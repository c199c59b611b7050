"""Halo-exchange transports: how a rank's send buffers reach the shards
that receive them.

Counterpart of `GreenGaussPallas._exchange_start` / `_exchange_finish`
(`cfd_proxy_tpu/models/gradients_pallas.py:851-878`: one `ppermute` per
phase over the device mesh) and of that mesh (`:368-372`: one shard per
device).  Here the P shards are spread over W processes ("ranks") of a
`torch.distributed` group: rank r holds shards [r·P/W, (r+1)·P/W), its
`(P_local, nph, rows, s_max)` send buffers in the wire dtype go in, and its
`recv` of the same shape comes out, with

    recv[q, k] = sendbufs[p, k]   for every pair (p, q) the phase moves.

Three transports:

- `Loopback`: every shard in this process; one indexed copy
  (`ops/blocksweep.py::loopback`).  Moves the completed permutation `dsts`.
- `Dist`: per phase k one `torch.distributed.batch_isend_irecv` over the
  pairs of `perms[k]` whose two shards live on different ranks, the other
  pairs by local copy; receivers outside the perm read zeros, phases with
  an empty perm post nothing (the reference skips them, `:859-861`).
  `start()` posts, `finish()` waits, so a step can sweep in between.  The
  route follows the tensors and the group's backend and is named in
  `Dist.name`: "dist/nccl" (CUDA tensors, one rank per GPU), "dist/gloo"
  (CPU tensors), "dist/gloo-staged" (CUDA tensors under a gloo group: staged
  through pinned host buffers).
- `Peer`: no transfer of its own.  It owns the rank's persistent exchange
  memory (receive buffers, flag words, the two launch epoch words the
  kernels advance and the four words that count their waits, one
  `cudaMalloc` block), publishes
  it to the other ranks through CUDA IPC, maps theirs, and hands the fused
  kernel K3 and the push bench's K6 a device table of peer addresses; the
  kernels do the pushes (csrc/push_common.cuh).  CUDA only.

The extra pairs of the completed permutation carry send-masked zeros, so
`Loopback` and `Dist` fill the ghost regions of real pairs alike.
"""

from __future__ import annotations

import atexit
import ctypes
import socket
import weakref

import numpy as np
import torch
import torch.distributed as dist

from cfd_proxy_tpu_torch.ops.blocksweep import (check_push_map, expect_aligned,
                                                loopback)
from cfd_proxy_tpu_torch.utils import spans
from cfd_proxy_tpu_torch.utils.errors import check

TRANSPORTS = ("loopback", "dist", "peer")
DIST_BACKENDS = ("nccl", "gloo")


def group_size(group) -> tuple[int, int]:
    """(rank, world size) of a process group; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def gather_shards(x: torch.Tensor, group) -> torch.Tensor:
    """(P_local, ...) on this rank → (P, ...) on the host, the same on every
    rank: one all_gather over the group (on the device under nccl, on the
    host under gloo, which gathers CPU tensors)."""
    _, world = group_size(group)
    if world == 1:
        return x.cpu()
    if dist.get_backend(group) != "nccl":
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.cat(out).cpu()


def shard_range(nshards: int, rank: int, world: int) -> tuple[int, int]:
    """Rank r of W holds shards [r·P/W, (r+1)·P/W); W must divide P."""
    check(world >= 1 and nshards % world == 0,
          "%d ranks do not divide %d shards", world, nshards)
    n = nshards // world
    return rank * n, (rank + 1) * n


class Loopback:
    """Every shard in this process: the W = 1 transport."""

    name = "loopback"

    def __init__(self, dsts, device):
        self.dst_index = torch.as_tensor(np.asarray(dsts), dtype=torch.int64,
                                         device=device)

    def start(self, sendbufs: torch.Tensor) -> torch.Tensor:
        with spans.span("exchange", sendbufs.device):
            return loopback(sendbufs, self.dst_index)

    def finish(self, pending: torch.Tensor) -> torch.Tensor:
        return pending

    def exchange(self, sendbufs: torch.Tensor) -> torch.Tensor:
        return self.finish(self.start(sendbufs))


class Dist:
    """Point-to-point exchange over a `torch.distributed` group."""

    def __init__(self, perms, nshards: int, group, device,
                 share_device: bool = False, self_sends: bool = False):
        """perms: per phase the (src, dst) shard pairs that move data.
        self_sends: post the pairs inside this rank on the backend too, not
        as local copies (a check that the backend's route works where only
        one rank is at hand)."""
        self.group = group
        self.rank, self.world = group_size(group)
        self.lo, self.hi = shard_range(nshards, self.rank, self.world)
        self.device = torch.device(device)
        backend = dist.get_backend(group) if group is not None else "gloo"
        check(backend in DIST_BACKENDS, "dist transport: backend %s (one of "
              "%s)", backend, "/".join(DIST_BACKENDS))
        cuda = self.device.type == "cuda"
        check(backend != "nccl" or cuda, "dist transport: nccl moves CUDA "
              "tensors only (use --dist-backend gloo on the CPU)")
        check(not (backend == "nccl" and share_device), "dist transport: "
              "nccl with two ranks on one device is not supported by NCCL "
              "(use --dist-backend gloo, staged through the host, or the "
              "peer transport)")
        self.staged = cuda and backend == "gloo"
        self.name = f"dist/{backend}" + ("-staged" if self.staged else "")
        n = self.hi - self.lo
        # per phase: local pairs as index lists, remote pairs as
        # (local shard, peer rank, tag); tag = k·P + dst shard is unique per
        # message (one sender per receiver and phase)
        self.local, self.sends, self.recvs = [], [], []
        self._pin: dict = {}
        for k, perm in enumerate(perms):
            loc, snd, rcv = ([], []), [], []
            for s, d in perm:
                rs, rd = s // n, d // n
                tag = k * nshards + d
                if rs == self.rank and rd == self.rank and not self_sends:
                    loc[0].append(s - self.lo)
                    loc[1].append(d - self.lo)
                    continue
                if rs == self.rank:
                    snd.append((s - self.lo, rd, tag))
                if rd == self.rank:
                    rcv.append((d - self.lo, rs, tag))
            self.local.append(tuple(
                torch.tensor(i, dtype=torch.int64, device=self.device)
                for i in loc) if loc[0] else None)
            self.sends.append(snd)
            self.recvs.append(rcv)

    def _peer(self, rank: int) -> int:
        """A group rank as the global rank the point-to-point calls take."""
        return rank if self.group is None else \
            dist.get_global_rank(self.group, rank)

    def start(self, sendbufs: torch.Tensor):
        """Post every phase's transfers, in span "exchange"; returns what
        `finish` takes."""
        with spans.span("exchange", sendbufs.device):
            return self._start(sendbufs)

    def _start(self, sendbufs: torch.Tensor):
        nph = len(self.local)
        check(sendbufs.dim() == 4 and sendbufs.shape[0] == self.hi - self.lo
              and sendbufs.shape[1] == nph and sendbufs.is_contiguous()
              and sendbufs.device.type == self.device.type,
              "dist transport: sendbufs %s on %s, expected (%d, %d, rows, "
              "s_max) contiguous on %s", tuple(sendbufs.shape),
              sendbufs.device, self.hi - self.lo, nph, self.device)
        recv = torch.zeros_like(sendbufs)
        for k, loc in enumerate(self.local):
            if loc is not None:
                recv[loc[1], k] = sendbufs[loc[0], k]
        if not any(self.sends) and not any(self.recvs):
            return recv, None, []
        wire_out, wire_in = sendbufs, recv
        if self.staged:
            # gloo reads host memory: the payload crosses through pinned
            # buffers, final before the sends are posted
            wire_out, wire_in = self._pinned(sendbufs)
            wire_out.copy_(sendbufs, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        ops = []
        for k in range(nph):        # the same order on both sides of a pair
            for p, r, tag in self.sends[k]:
                ops.append(dist.P2POp(dist.isend, _bytes(wire_out[p, k]),
                                      self._peer(r), self.group, tag))
            for p, r, tag in self.recvs[k]:
                ops.append(dist.P2POp(dist.irecv, _bytes(wire_in[p, k]),
                                      self._peer(r), self.group, tag))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return recv, (wire_in if self.staged else None), reqs

    def _pinned(self, like: torch.Tensor):
        """The pinned (out, in) host pair for buffers like `like`, kept
        across steps (pinning memory is a slow CUDA call); one exchange per
        shape is pending at a time."""
        key = (tuple(like.shape), like.dtype)
        if key not in self._pin:
            self._pin[key] = tuple(
                torch.zeros(like.shape, dtype=like.dtype, pin_memory=True)
                for _ in range(2))
        return self._pin[key]

    def finish(self, pending) -> torch.Tensor:
        """Wait for the transfers `start` posted, in span "exchange"; returns
        recv."""
        with spans.span("exchange", pending[0].device):
            return self._finish(pending)

    def _finish(self, pending) -> torch.Tensor:
        recv, staged, reqs = pending
        for r in reqs:
            r.wait()
        if staged is not None:
            for k, rcv in enumerate(self.recvs):
                for p, _, _ in rcv:
                    recv[p, k].copy_(staged[p, k], non_blocking=True)
            # the pinned buffer must outlive the copies enqueued from it
            torch.cuda.current_stream(self.device).synchronize()
        return recv

    def exchange(self, sendbufs: torch.Tensor) -> torch.Tensor:
        return self.finish(self.start(sendbufs))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer as flat bytes: the wire carries no dtype."""
    return t.view(-1).view(torch.uint8)


# ------------------------------------------------------------------ peer

def peer_layout(nlocal: int, nph: int, seg_bytes: int) -> dict:
    """Byte offsets inside one rank's exchange block (push_common.cuh):
    recv (nlocal, nph, seg_bytes), then u64 words ready (nlocal, nph),
    arrive (nlocal, nph), done, the two launch epochs (the rank's
    launches so far with the barrier, and with the copy) and the four wait
    words (WAIT_COUNTERS: the readiness waits' ns and count, the arrival
    waits' ns and count, of the waits that spun)."""
    npk = nlocal * nph
    flags = -(-npk * seg_bytes // 256) * 256
    epochs = flags + 16 * npk + 8
    return {"recv": 0, "flags": flags, "ready": flags,
            "arrive": flags + 8 * npk, "done": flags + 16 * npk,
            "epochs": epochs, "waits": epochs + 16, "bytes": epochs + 48}


# the wait words of peer_layout, in order, under their counters' names
WAIT_COUNTERS = ("peer_wait_barrier_ns", "peer_waits_barrier",
                 "peer_wait_arrive_ns", "peer_waits_arrive")


def read_waits() -> None:
    """Add what every open `Peer`'s wait words grew by since the last read
    to this function's attributes, the counters WAIT_COUNTERS
    (`wait_counters()`): a copy from the device, so call it after a
    synchronise (`utils/spans.py::read` does, while the recorder is on).
    A closed transport's growth before its last read stays counted."""
    for p in list(_open_peers):
        p._read_waits()


def wait_counters() -> dict:
    """{name: (function, attribute)} of the wait counters, 0 until a read
    finds a `Peer` whose kernels waited."""
    return {k: (read_waits, k) for k in WAIT_COUNTERS}


read_waits.__dict__.update(dict.fromkeys(WAIT_COUNTERS, 0))


def peer_table(dsts: np.ndarray, srcs: np.ndarray, lo: int, hi: int,
               bases: dict, seg_bytes: int) -> np.ndarray:
    """(nlocal·nph, 3) uint64 address table of rank shards [lo, hi): per
    local (p, k) the address of recv[dsts[p, k], k], of that buffer's
    arrive word, and of ready[srcs[p, k], k]; bases: {rank: base address of
    that rank's block as this process sees it}."""
    nph = dsts.shape[1]
    n = hi - lo
    lay = peer_layout(n, nph, seg_bytes)
    out = np.zeros((n, nph, 3), np.uint64)
    for p in range(n):
        for k in range(nph):
            d, s = int(dsts[lo + p, k]), int(srcs[lo + p, k])
            dpk = (d % n) * nph + k
            spk = (s % n) * nph + k
            out[p, k] = (bases[d // n] + lay["recv"] + dpk * seg_bytes,
                         bases[d // n] + lay["arrive"] + 8 * dpk,
                         bases[s // n] + lay["ready"] + 8 * spk)
    return out.reshape(n * nph, 3)


class _DeviceBlock:
    """A raw device allocation shown to torch (`torch.as_tensor`)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


_open_peers: "weakref.WeakSet[Peer]" = weakref.WeakSet()


@atexit.register
def _close_mappings() -> None:
    """Unmap whatever a transport left mapped: a process that exits with
    another's memory still open can hang there."""
    for p in list(_open_peers):
        p._unmap()


class Peer:
    """The rank's persistent exchange memory, mapped across ranks.

    dsts / srcs: (P, nph) the completed push permutation per phase and its
    inverse, over ALL shards; shape (rows, s_max) and dtype of one (shard,
    phase) buffer.  `recv` is the rank's (P_local, nph, rows, s_max)
    receive tensor, `table` the device address table and `flags` the flag
    words' address, as the kernels take them.  `epoch_words` views the two
    launch epoch words (int64 on the device: the launches so far with the
    barrier, and with the copy), which the kernels read and advance, so a
    launch holds no host counter and replays as part of a CUDA graph; every
    rank must launch the same modes in the same order.  `wait_words` views
    the four words that count the kernels' waits that spun (WAIT_COUNTERS),
    which only `read_waits()` copies to the host.  The ranks must all
    sit on one node: CUDA IPC maps memory between processes of one host.
    `close()` (collective) unmaps and frees."""

    name = "peer"

    def __init__(self, dsts, srcs, *, rows: int, s_max: int,
                 dtype: torch.dtype, device, group=None):
        self.device = torch.device(device)
        check(self.device.type == "cuda", "the peer transport maps device "
              "memory between ranks and has no CPU form (use --transport "
              "dist on the CPU)")
        from cfd_proxy_tpu_torch.ops import _cuda

        self._lib = _cuda.lib()
        dsts = np.ascontiguousarray(dsts, np.int32)
        srcs = np.ascontiguousarray(srcs, np.int32)
        check_push_map(dsts, srcs)
        nshards, self.nph = dsts.shape
        self.group = group
        self.rank, self.world = group_size(group)
        self.lo, self.hi = shard_range(nshards, self.rank, self.world)
        n = self.hi - self.lo
        esize = torch.empty((), dtype=dtype).element_size()
        self.seg_bytes = rows * s_max * esize
        check(self.seg_bytes % 16 == 0, "peer transport: a (%d, %d) %s "
              "buffer is not a multiple of 16 bytes (16-byte copies)", rows,
              s_max, dtype)
        self.shape = (n, self.nph, rows, s_max)
        self.dtype = dtype
        lay = peer_layout(n, self.nph, self.seg_bytes)
        self._dev = self.device.index or 0
        ptr = ctypes.c_void_p()
        _cuda.check_launch(self._lib.cfd_ipc_alloc(
            self._dev, lay["bytes"], ctypes.byref(ptr)), "peer allocation")
        self._base = ptr.value
        self._mapped: dict[int, int] = {}
        bases = {self.rank: self._base}
        if self.world > 1:
            handle = ctypes.create_string_buffer(64)
            _cuda.check_launch(self._lib.cfd_ipc_export(self._base, handle),
                               "peer export")
            mine = (socket.gethostname(), handle.raw)
            every = [None] * self.world
            dist.all_gather_object(every, mine, group=group)
            need = {int(q) // n for q in
                    np.concatenate([dsts[self.lo:self.hi].ravel(),
                                    srcs[self.lo:self.hi].ravel()])}
            for r in sorted(need - {self.rank}):
                host, raw = every[r]
                check(host == mine[0], "peer transport: rank %d runs on %s, "
                      "rank %d on %s; in-kernel pushes need both on one "
                      "node (route such phases through --slice-size)",
                      self.rank, mine[0], r, host)
                mapped = ctypes.c_void_p()
                _cuda.check_launch(self._lib.cfd_ipc_open(
                    self._dev, raw, ctypes.byref(mapped)),
                    f"peer mapping of rank {r}")
                self._mapped[r] = bases[r] = mapped.value
        _open_peers.add(self)
        block = torch.as_tensor(_DeviceBlock(self._base, lay["bytes"]),
                                device=self.device)
        self._block = block
        self.recv = block[:n * self.nph * self.seg_bytes].view(dtype).view(
            self.shape)
        self.flags = self._base + lay["flags"]
        self.epoch_words = block[lay["epochs"]:lay["waits"]].view(
            torch.int64)
        self.wait_words = block[lay["waits"]:lay["bytes"]].view(torch.int64)
        self._waits_read = [0] * len(WAIT_COUNTERS)
        self.table = torch.from_numpy(
            peer_table(dsts, srcs, self.lo, self.hi, bases, self.seg_bytes)
            .view(np.int64)).to(self.device)
        if self.world > 1:
            dist.barrier(group=group)   # every rank mapped before any push

    def check_sendbufs(self, sendbufs: torch.Tensor) -> None:
        check(tuple(sendbufs.shape) == self.shape
              and sendbufs.dtype == self.dtype
              and sendbufs.device.type == self.device.type,
              "peer transport: sendbufs %s %s on %s, expected %s %s on %s",
              tuple(sendbufs.shape), sendbufs.dtype, sendbufs.device,
              self.shape, self.dtype, self.device)
        expect_aligned(sendbufs, "sendbufs")

    def _read_waits(self) -> None:
        if getattr(self, "wait_words", None) is None:
            return
        now = self.wait_words.tolist()
        for k, n, was in zip(WAIT_COUNTERS, now, self._waits_read):
            setattr(read_waits, k, getattr(read_waits, k) + n - was)
        self._waits_read = now

    def _unmap(self) -> None:
        for r, ptr in list(self._mapped.items()):
            self._lib.cfd_ipc_close(self._dev, ptr)
            del self._mapped[r]

    def close(self) -> None:
        """Unmap the peers' memory, then free this rank's (collective: a
        block is freed only after every importer has unmapped it)."""
        if self._base is None:
            return
        torch.cuda.synchronize(self.device)
        self._unmap()
        if self.world > 1:
            dist.barrier(group=self.group)
        self.recv = self.table = self._block = self.epoch_words = None
        self.wait_words = None
        self._lib.cfd_ipc_free(self._dev, self._base)
        self._base = None
        _open_peers.discard(self)
