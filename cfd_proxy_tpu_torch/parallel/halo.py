"""Halo exchange of the ELL model: gather-pack → transport → unpack.

Counterpart of `cfd_proxy_tpu/parallel/halo.py`.  The reference packs each
phase's send rows with a gather, moves the buffers with one `ppermute` per
phase, and writes them into the ghost rows with a scatter whose padding
lanes (recv index `npoint_pad`) are dropped.  Here the buffers travel
through the port's transports (`parallel/transport.py`): `Loopback` (the P
shards of one process: one indexed copy over the completed permutation) or
`Dist` (the shards of W ranks: `batch_isend_irecv` over the phase pairs).
Both take (P_local, nph, rows, s_max) buffers; the ELL model's arrays are
row-major (npoint_pad, C), so the pack transposes each buffer to (C,
s_max) and the unpack transposes back.

The unpack writes only real lanes: `DeviceHalo.stack` lists them once on
the host (flat row of the stacked array, flat lane of the received
buffers), so no padding index reaches the device (torch's index ops would
raise on it, or assert on a card).  Every ghost row is filled by exactly
one lane (`MeshPartition.validate` pins global recvidx uniqueness), so one
`index_copy_` over all phases equals the per-phase chain.

`exchange_start` gathers owned rows only and `exchange_finish` writes ghost
rows only, so a sweep that writes owned rows can run between them (the
early schedule).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cfd_proxy_tpu_torch.parallel.topology import HaloTopology
from cfd_proxy_tpu_torch.parallel.transport import Dist, Loopback
from cfd_proxy_tpu_torch.utils.errors import check


@dataclass(frozen=True)
class HostHalo:
    """One shard's phase metadata, padded to a common S_max (NumPy)."""

    send_idx: np.ndarray     # (nph, S) int32; pad 0
    recv_idx: np.ndarray     # (nph, S) int32; pad npoint_pad (dropped)
    perms: tuple             # perms[k]: phase k's (src, dst) shard pairs


def device_halo(topo: HaloTopology, part_id: int) -> HostHalo:
    """One shard's phase metadata, padded to uniform S_max (counterpart of
    the reference's `device_halo`)."""
    smax = max(topo.max_phase_size(), 1)
    nph = max(topo.nphases, 1)
    send = np.zeros((nph, smax), dtype=np.int32)
    recv = np.full((nph, smax), topo.npoint_pad, dtype=np.int32)
    perms = []
    for k, ph in enumerate(topo.phases):
        s = ph.send_idx.shape[1]
        send[k, :s] = ph.send_idx[part_id]
        recv[k, :s] = ph.recv_idx[part_id]
        perms.append(tuple(ph.perm))
    return HostHalo(send_idx=send, recv_idx=recv, perms=tuple(perms))


def complete_perms(perms: tuple, nshards: int) -> np.ndarray:
    """(P, nph) destination of every shard in every phase: the phase's pairs,
    the unmatched senders paired with the unmatched receivers (what they
    deliver lands in receivers whose recv lanes are all padding)."""
    dsts = np.full((nshards, len(perms)), -1, dtype=np.int64)
    for k, perm in enumerate(perms):
        taken = set()
        for s, d in perm:
            dsts[s, k] = d
            taken.add(d)
        free = [d for d in range(nshards) if d not in taken]
        for s in range(nshards):
            if dsts[s, k] < 0:
                dsts[s, k] = free.pop(0)
    return dsts


@dataclass(frozen=True)
class DeviceHalo:
    """A rank's shards' phase metadata on the device, and the transport
    their buffers travel by."""

    send_idx: torch.Tensor   # (P_local, nph·S) int64: rows packed, phase-major
    recv_rows: torch.Tensor  # (M,) int64: flat row p·npoint_pad + ghost row
    recv_lanes: torch.Tensor  # (M,) int64: flat lane (p, k, j) of the same
    nph: int                 # phases the buffers carry (0: nothing moves)
    smax: int
    transport: object        # Loopback or Dist

    @staticmethod
    def stack(halos: list[HostHalo], npoint_pad: int, lo: int, hi: int,
              device, group=None, share_device: bool = False
              ) -> "DeviceHalo":
        """Shards [lo, hi) of `halos` (all P shards' HostHalo) on `device`,
        with their transport: Loopback without a group, else Dist."""
        P = len(halos)
        perms = halos[0].perms
        nph = len(perms)
        smax = halos[0].send_idx.shape[1]
        send = np.stack([h.send_idx for h in halos[lo:hi]])
        recv = np.stack([h.recv_idx for h in halos[lo:hi]])
        check(send.shape == recv.shape == (hi - lo, max(nph, 1), smax),
              "halo shapes %s / %s", send.shape, recv.shape)
        check(int(send.min(initial=0)) >= 0
              and int(send.max(initial=0)) < npoint_pad,
              "send rows outside [0, %d)", npoint_pad)
        real = recv < npoint_pad
        p, k, j = np.nonzero(real)
        rows = p * npoint_pad + recv[real].astype(np.int64)
        lanes = (p * max(nph, 1) + k) * smax + j
        check(np.unique(rows).size == rows.size, "a ghost row is received "
              "twice (partitions must pass MeshPartition.validate)")
        if group is None:
            transport = Loopback(complete_perms(perms, P), device)
        else:
            transport = Dist(perms, P, group, device, share_device)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                   device=device)

        return DeviceHalo(send_idx=dev(send[:, :nph].reshape(hi - lo, -1)),
                          recv_rows=dev(rows), recv_lanes=dev(lanes),
                          nph=nph, smax=smax, transport=transport)


def exchange_start(x: torch.Tensor, halo: DeviceHalo, *,
                   scale: torch.Tensor | None = None):
    """Pack every phase's send rows of x (P_local, npoint_pad, C) (owned
    rows, final), times `scale` (P_local, npoint_pad, 1) when given, and
    post them; returns what `exchange_finish` takes (None: no phase)."""
    if halo.nph == 0:
        return None
    P, _, C = x.shape
    buf = torch.gather(x, 1, halo.send_idx.unsqueeze(-1).expand(-1, -1, C))
    if scale is not None:
        buf = buf * torch.gather(scale, 1, halo.send_idx.unsqueeze(-1))
    buf = buf.view(P, halo.nph, halo.smax, C).transpose(2, 3).contiguous()
    return halo.transport.start(buf)


def exchange_finish(x: torch.Tensor, pending, halo: DeviceHalo
                    ) -> torch.Tensor:
    """Write the received lanes into x's ghost rows, in place; returns x."""
    if pending is None:
        return x
    recv = halo.transport.finish(pending)           # (P, nph, C, S)
    C = x.shape[-1]
    lanes = recv.transpose(2, 3).reshape(-1, C).index_select(
        0, halo.recv_lanes)
    x.view(-1, C).index_copy_(0, halo.recv_rows, lanes)
    return x


def exchange(x: torch.Tensor, halo: DeviceHalo) -> torch.Tensor:
    """Bulk-synchronous exchange: start, then finish, in place on x."""
    return exchange_finish(x, exchange_start(x, halo), halo)
