"""Halo-exchange topology: comm lists → exchange phase schedule.

NumPy copy of `cfd_proxy_tpu/parallel/topology.py`: the port imports
nothing of the JAX package and carries its own host layer.  The code is the
original's line for line; tests/test_torch_plan.py holds the two equal.

A device with several partners sends in several phases.  Scheduling the
directed sends into phases is edge coloring of the communication multigraph:
within a phase every device sends to at most one partner and receives from at
most one partner.  Greedy coloring on the (round-ordered) edge list gives at
most 2·maxdeg−1 phases; exchange rounds (= ghost depth) stay sequential.

All per-device metadata is padded to uniform shapes: send gather lists pad
with 0 (harmless gather), recv scatter lists pad with an out-of-bounds index
that the unpack discards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy_tpu_torch.mesh.model import MeshPartition
from cfd_proxy_tpu_torch.utils.errors import check


@dataclass
class PhaseSpec:
    """One exchange phase: static (src→dst) pairs + per-device index lists."""

    round: int
    perm: list[tuple[int, int]]          # static (src, dst) pairs
    send_idx: np.ndarray                 # (P, S_max) i32; pad = 0
    recv_idx: np.ndarray                 # (P, S_max) i32; pad = npoint_pad (OOB)
    inter_slice: bool = False            # phase crosses slice (node) boundaries


@dataclass
class HaloTopology:
    """Full phase schedule for one partitioned mesh."""

    npart: int
    npoint_pad: int                      # uniform padded point count
    nrounds: int
    phases: list[PhaseSpec]

    @property
    def nphases(self) -> int:
        return len(self.phases)

    def max_phase_size(self) -> int:
        return max((p.send_idx.shape[1] for p in self.phases), default=0)


def entry_phases(parts: list[MeshPartition],
                 topo: HaloTopology) -> list[np.ndarray]:
    """Per shard: phase id of each comm entry (aligned with part.comm).

    The one definition of entry→phase matching.  Recv-only entries (empty
    sendidx) are carried by no send phase of their shard and default to 0,
    which is inert downstream (their signature-membership rows are
    empty)."""
    out = []
    for d, p in enumerate(parts):
        out.append(np.array([
            next((k for k, ph in enumerate(topo.phases)
                  if ph.round == e.round and (d, e.partner) in ph.perm), 0)
            for e in p.comm], dtype=np.int64))
    return out


def build_halo_topology(
    parts: list[MeshPartition], npoint_pad: int, *, slice_size: int | None = None
) -> HaloTopology:
    """Edge-color the comm graph into exchange phases, round by round.

    slice_size (multi-node deployments): devices [k*slice_size,
    (k+1)*slice_size) form node k.  Intra-node edges are colored into the
    EARLIEST phases and inter-node edges into separate LATER phases — never
    mixed, so each phase is pure intra- or pure inter-node and the
    early/overlap schedules can hide the slow phases under interior compute.
    Device ids are assumed node-major; the RCB partition order makes
    consecutive partitions geometric neighbors, so most halo traffic stays
    intra-node by construction.
    """
    P = len(parts)
    check(P >= 1, "need at least one partition")
    check(slice_size is None or slice_size >= 1,
          "slice_size must be >= 1, got %r", slice_size)
    for pt in parts:
        check(pt.npoint <= npoint_pad, "npoint_pad %d < npoint %d", npoint_pad, pt.npoint)

    def crosses(s: int, d: int) -> bool:
        return slice_size is not None and (s // slice_size) != (d // slice_size)

    nrounds = max((pt.nrounds for pt in parts), default=0)
    phases: list[PhaseSpec] = []
    # positional identity: parts[i] must BE partition i — partner lookups
    # below are positional
    for i, pt in enumerate(parts):
        check(pt.part_id == i,
              "parts out of order: index %d holds part_id %d", i, pt.part_id)
    # reverse lookup (owner, partner, round) → comm entry, built once
    rev: dict[tuple[int, int, int], object] = {}
    for pt in parts:
        for e in pt.comm:
            key = (pt.part_id, e.partner, e.round)
            check(key not in rev, "duplicate comm entry %d->%d round %d", *key)
            rev[key] = e
    for r in range(nrounds):
        # directed edges with payload: (src, dst, sendidx, recvidx)
        edges = []
        for pt in parts:
            for e in pt.comm:
                if e.round != r:
                    continue
                # pairing is validated for EVERY entry, including empty
                # senders
                back = rev.get((e.partner, pt.part_id, r))
                check(back is not None, "unpaired comm entry %d->%d round %d",
                      pt.part_id, e.partner, r)
                check(back.recvidx.size == e.sendidx.size,
                      "send/recv size mismatch %d->%d", pt.part_id, e.partner)
                if e.sendidx.size:
                    # sort pairs by SENDER index: receiver ghost columns are
                    # assigned positionally (tlayout), so jointly permuting
                    # the pair order is free and keeps send lists monotone
                    o = np.argsort(e.sendidx, kind="stable")
                    edges.append((pt.part_id, e.partner, e.sendidx[o],
                                  back.recvidx[o]))

        # greedy edge coloring per transport class: intra-node edges first,
        # inter-node edges into separate later phases.
        # deterministic order within a class: sort by (src, dst)
        edges.sort(key=lambda t: (crosses(t[0], t[1]), t[0], t[1]))
        for inter in (False, True):
            cls = [e for e in edges if crosses(e[0], e[1]) == inter]
            phase_of = []
            used_src: list[set] = []
            used_dst: list[set] = []
            for (s, d, _si, _ri) in cls:
                k = 0
                while k < len(used_src) and (s in used_src[k] or d in used_dst[k]):
                    k += 1
                if k == len(used_src):
                    used_src.append(set())
                    used_dst.append(set())
                used_src[k].add(s)
                used_dst[k].add(d)
                phase_of.append(k)

            for k in range(len(used_src)):
                sel = [e for e, ph in zip(cls, phase_of) if ph == k]
                smax = max(e[2].size for e in sel)
                send_idx = np.zeros((P, smax), dtype=np.int32)
                recv_idx = np.full((P, smax), npoint_pad, dtype=np.int32)  # OOB→drop
                perm = []
                for (s, d, si, ri) in sel:
                    perm.append((s, d))
                    send_idx[s, : si.size] = si
                    recv_idx[d, : ri.size] = ri
                phases.append(PhaseSpec(round=r, perm=perm, send_idx=send_idx,
                                        recv_idx=recv_idx, inter_slice=inter))

    return HaloTopology(npart=P, npoint_pad=npoint_pad, nrounds=nrounds,
                        phases=phases)
