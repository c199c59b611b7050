"""Host-side mesh/state data model (SoA, NumPy).

Mirrors the reference's mesh + comm structs (SURVEY.md §2 L1/L2: per-partition
point coords, face→(p0,p1) adjacency, face normals, ownership counts, and the
`comm_data` per-neighbor send/recv index lists from `comm_data.h` /
`setup_comm.c`).  Layout invariants, identical to the reference's:

- points are ordered **owned first, then ghosts**; `nowned` splits them;
- ghosts are grouped by increasing halo depth (depth-1 ghosts before depth-2);
- `faces[f] = (p0, p1)` indexes into the local point array;
- each comm entry belongs to a *round*: round r fills depth-(r+1) ghosts
  (the multi-round ghost-layer scheme of SURVEY.md §3 / BASELINE config 5);
  sendidx always references OWNED points (see CommEntry) so rounds pack
  independently.

The port's copy of `cfd_proxy_tpu/mesh/model.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cfd_proxy_tpu_torch.utils.errors import check, check_index_array


@dataclass
class CommEntry:
    """One (neighbor, round) communication list — `comm_data` analogue.

    sendidx: local point indices whose values the partner needs (gather/pack).
    recvidx: local ghost point slots the partner's data lands in (scatter).
    Both sides store their lists in the SAME order, so sendbuf[i] on the
    sender corresponds to recvidx[i] on the receiver (position-matched, like
    the reference's paired send/recv buffers).

    Invariant (all rounds): sendidx references OWNED points only — the owner
    of a point sends directly to every partition that ghosts it, at any
    depth.  This is what makes every round's packing independent of earlier
    rounds, so the device exchange may fire all rounds' ppermutes/RDMA pushes
    concurrently (parallel/halo.py).  A relay scheme (round-r sends sourcing
    depth-<r ghosts) would need sequential rounds and is deliberately NOT
    supported.
    """

    partner: int
    round: int
    sendidx: np.ndarray
    recvidx: np.ndarray

    def validate(self, npoint: int, nowned: int) -> None:
        check_index_array(self.sendidx, name="sendidx", lo=0, hi=nowned)
        check_index_array(self.recvidx, name="recvidx", lo=nowned, hi=npoint, unique=True)


@dataclass
class MeshPartition:
    """One mesh partition: geometry + state layout + comm metadata."""

    part_id: int
    npart: int
    nowned: int
    coords: np.ndarray        # (npoint, 3) f64 — owned then ghosts
    global_ids: np.ndarray    # (npoint,) i32 — global point id of each local point
    faces: np.ndarray         # (nface, 2) i32 — local point indices
    normals: np.ndarray       # (nface, 3) f64 — face normal (area-weighted)
    volume: np.ndarray        # (npoint,) f64 — dual-cell volume (grad scaling)
    comm: list[CommEntry] = field(default_factory=list)

    @property
    def npoint(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nghost(self) -> int:
        return self.npoint - self.nowned

    @property
    def nface(self) -> int:
        return int(self.faces.shape[0])

    @property
    def nrounds(self) -> int:
        return 1 + max((e.round for e in self.comm), default=-1)

    @property
    def neighbors(self) -> list[int]:
        return sorted({e.partner for e in self.comm})

    def validate(self) -> None:
        check(0 <= self.part_id < self.npart, "part_id %d out of range", self.part_id)
        check(self.coords.shape == (self.npoint, 3), "coords shape %s", self.coords.shape)
        check(self.global_ids.shape == (self.npoint,), "global_ids shape")
        check(self.faces.ndim == 2 and self.faces.shape[1] == 2,
              "faces shape %s", self.faces.shape)
        check(self.normals.shape == (self.nface, 3), "normals shape %s", self.normals.shape)
        check(self.volume.shape == (self.npoint,), "volume shape %s", self.volume.shape)
        check(0 <= self.nowned <= self.npoint, "nowned %d", self.nowned)
        if self.nface:
            check_index_array(self.faces.ravel(), name="faces", lo=0, hi=self.npoint)
        # each ghost slot is filled by exactly one comm entry
        recv_all = np.concatenate([e.recvidx for e in self.comm]) if self.comm else (
            np.zeros(0, np.int32))
        check(np.unique(recv_all).size == recv_all.size, "ghost slot filled twice")
        check(recv_all.size == self.nghost,
              "recvidx covers %d of %d ghosts", recv_all.size, self.nghost)
        for e in self.comm:
            e.validate(self.npoint, self.nowned)
