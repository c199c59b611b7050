"""GreenGaussTorch — the port's Green-Gauss model on the block-sweep kernels.

Counterpart of `cfd_proxy_tpu/models/gradients_pallas.py::GreenGaussPallas`
(packed kernel, f32, Green-Gauss) for P shards held on ONE device:

- `__init__`: block-size rule, RCB locality relabel (+ in-block degree sort
  for the compact layout), halo topology, transposed device layout, the
  bulk / boundary / interior BlockPlans of every shard padded to common
  shapes, pack-time scaling and the compact prefix widths — the reference's
  host construction, step for step, so both packages hold identical plan
  data;
- `distribute_state`: host state → stacked (P, NV, ndev) `var_T` + the
  packed source table of each class the requested schedules read
  (`pack_srcs` kernel);
- `step(state, s)` for s in bulk / early / overlap / nocomm (`sweep_blocks`
  kernel, with and without init; `sweep_blocks_overlap` kernel for
  overlap);
- `iterate_fn(s, n)`: the chained n-step loop the timing uses;
- `gather_global`: device rows d*NV+v → global (N, nvar*3) column v*3+d.

The halo exchange moves between shards on the same device (the loopback
transport): phase k's buffer of shard p lands in phase k's ghost region of
shard dsts[p, k].  The reference's ppermute moves only the pairs of
layout.perms[k] and leaves other receivers zero; the loopback moves the
completed permutation (dsts), whose extra pairs carry send-masked zeros, so
the ghost regions come out the same.  Pack, transfer and unpack are plain
torch ops, as they are XLA ops in the reference.

Options outside the slice raise `CheckError` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfd_proxy_tpu.mesh.model import MeshPartition
from cfd_proxy_tpu.mesh.partition import (
    rcb_owned_order,
    relabel_owned,
    send_point_set,
)
from cfd_proxy_tpu.utils.errors import check
from cfd_proxy_tpu_torch.ops.blocksweep import (
    ROWS,
    loopback,
    pack_srcs,
    slot_table,
    sweep_blocks,
    sweep_blocks_overlap,
)
from cfd_proxy_tpu_torch.ops.plan import (
    NV,
    _pad_blocks,
    _pad_plan_dims,
    build_block_plan,
    compact_slot_w,
    compact_src_cols,
    prefix_widths,
)
from cfd_proxy_tpu_torch.parallel.tlayout import (
    build_tlayout,
    device_faces,
    device_inv_scale,
)
from cfd_proxy_tpu_torch.parallel.topology import (
    HaloTopology,
    build_halo_topology,
    entry_phases,
)

# AUTO block-size rule (bp=None), kept from the reference so that both
# packages build the same layout; it is to be re-decided on the GPU.
BP_AUTO_SMALL = 262144
BP_SMALL = 1024
CLASSES = ("bulk", "boundary", "interior")
SCHEDULES = ("bulk", "early", "overlap", "nocomm")
# which source-table classes each schedule's step reads
SCHEDULE_CLASSES = {
    "bulk": ("bulk",), "nocomm": ("bulk",),
    "early": ("boundary", "interior"), "overlap": ("boundary", "interior"),
}
# the host arrays `from_arrays` takes (see convert.plans_from_jax);
# "classes" maps each class to a dict of CLASS_KEYS
PLAN_KEYS = ("ndev", "bp", "s_max", "ghost_start", "locmap", "send_idx",
             "send_mask", "pack_scale", "dsts", "srcs", "perms", "has_comm",
             "classes")
CLASS_KEYS = ("block_ids", "src_cols", "slot_w", "scale", "wks")


def check_entry_phases(parts: list[MeshPartition], topo: HaloTopology,
                       eph: list[np.ndarray]) -> None:
    """Every comm entry that sends must have found its exchange phase.

    `entry_phases` answers phase 0 both for recv-only entries (correct:
    they ride no phase of their own shard) and when no phase carries the
    entry at all; the second would silently mis-order the comm-first
    relabel, so it raises here."""
    for d, p in enumerate(parts):
        for e, k in zip(p.comm, eph[d]):
            if not e.sendidx.size:
                continue
            ph = topo.phases[k] if k < topo.nphases else None
            check(ph is not None and ph.round == e.round
                  and (d, e.partner) in ph.perm,
                  "comm entry %d->%d round %d has no exchange phase "
                  "(entry_phases fell back to phase %d)", d, e.partner,
                  e.round, k)


def host_plan_arrays(parts: list[MeshPartition], *, bp: int, kcompact: bool,
                     force_rdma: bool = False) -> dict:
    """Layout, exchange tables and the three class plans of RELABELED
    shards as host arrays (PLAN_KEYS), built exactly as
    `GreenGaussPallas.__init__` builds them (gradients_pallas.py:349-542)."""
    npoint_pad = max(p.npoint for p in parts) + 1
    topo = build_halo_topology(parts, npoint_pad)
    lay = build_tlayout(parts, topo, bp=bp)
    ones = np.ones(lay.ndev, dtype=np.float64)
    raw: dict[str, list] = {c: [] for c in CLASSES}
    pack_scale = np.zeros_like(lay.send_mask)
    for d, p in enumerate(parts):
        fd, nd = device_faces(p, lay)
        inv = device_inv_scale(p, lay)
        is_send = np.zeros(lay.ndev, bool)
        is_send[send_point_set(p)] = True
        bsel = is_send[fd[:, 0]] | is_send[fd[:, 1]]
        # bulk plan over faces reordered [boundary | interior], so each
        # point sums its boundary slots first, as boundary∘interior does;
        # the boundary class is UNSCALED (scale 1), scaled at pack time
        order = np.concatenate([np.flatnonzero(bsel), np.flatnonzero(~bsel)])
        pack_scale[d] = lay.send_mask[d] * inv[lay.send_idx[d]]
        raw["bulk"].append(build_block_plan(fd[order], nd[order], lay.ndev,
                                            inv, bp=bp, all_blocks=True,
                                            dst_lt=p.nowned))
        raw["boundary"].append(build_block_plan(fd, nd, lay.ndev, ones,
                                                bp=bp, face_sel=bsel,
                                                dst_lt=p.nowned))
        raw["interior"].append(build_block_plan(fd, nd, lay.ndev, inv, bp=bp,
                                                face_sel=~bsel,
                                                all_blocks=True,
                                                dst_lt=p.nowned))
    classes = {}
    for c in CLASSES:
        ep = max(pl.ep for pl in raw[c])
        ks = max(pl.kslots for pl in raw[c])
        nb = max(pl.nblocks for pl in raw[c])
        padded = [_pad_blocks(_pad_plan_dims(pl, ep, ks), nb,
                              lay.ndev // bp - 1) for pl in raw[c]]
        sw = np.stack([pl.slot_w for pl in padded])
        wks = prefix_widths(sw, bp) if kcompact else (bp,) * ks
        classes[c] = {
            "block_ids": np.stack([pl.block_ids for pl in padded]),
            "src_cols": np.stack([compact_src_cols(pl, wks)
                                  for pl in padded]),
            "slot_w": compact_slot_w(sw, wks),
            "scale": np.stack([pl.scale for pl in padded]),
            "wks": wks,
        }
    return {
        "ndev": lay.ndev, "bp": bp, "s_max": lay.s_max,
        "ghost_start": lay.ghost_start, "locmap": lay.locmap,
        "send_idx": lay.send_idx, "send_mask": lay.send_mask,
        "pack_scale": pack_scale, "dsts": lay.dsts, "srcs": lay.srcs,
        "perms": lay.perms,
        # overlap runs the fused kernel only when a phase moves data, or
        # when forced (P=1: self-sends of masked zeros); else it is early
        "has_comm": any(len(p) for p in lay.perms) or force_rdma,
        "classes": classes,
    }


def auto_bp(parts: list[MeshPartition], bp: int | None) -> int:
    """The reference's block-size rule without its interpret-mode cap:
    AUTO (None) is 4096 for shards of >= BP_AUTO_SMALL owned points, else
    BP_SMALL; the result is capped at the 128-rounded shard size."""
    if bp is None:
        bp = 4096 if max(p.nowned for p in parts) >= BP_AUTO_SMALL else \
            BP_SMALL
    check(bp > 0 and bp % 128 == 0, "bp must be a positive multiple of 128, "
          "got %d", bp)
    cap = max(p.npoint for p in parts) + 1
    cap = ((cap + 127) // 128) * 128
    return min(bp, cap)


class GreenGaussTorch(nn.Module):
    """Green-Gauss sweep + halo exchange of P shards on one device."""

    def __init__(self, parts: list[MeshPartition], nvar: int, *,
                 bp: int | None = None, kcompact: bool | None = None,
                 force_rdma: bool = False,
                 device: str | torch.device = "cuda",
                 arrays: dict | None = None):
        """parts: the raw partitions (relabeled here, as the reference
        does), or — with `arrays` — partitions ALREADY relabeled by the
        model the arrays come from (see `from_arrays`)."""
        super().__init__()
        check(1 <= nvar <= NV, "nvar %d outside [1, %d]", nvar, NV)
        self.nvar = int(nvar)
        self.device = torch.device(device)
        if arrays is None:
            self.kcompact = True if kcompact is None else bool(kcompact)
            self.bp = auto_bp(parts, bp)
            # pre-topology on the raw parts: phase ids for the comm-first
            # grouping of the relabel (the relabel keeps the comm graph, so
            # the final topology has the same phases)
            pre_topo = build_halo_topology(parts,
                                           max(p.npoint for p in parts) + 1)
            eph = entry_phases(parts, pre_topo)
            check_entry_phases(parts, pre_topo, eph)
            self.parts = [
                relabel_owned(p, rcb_owned_order(p, block=self.bp,
                                                 degree_sort=self.kcompact,
                                                 entry_phase=eph[d]))
                for d, p in enumerate(parts)
            ]
            arrays = host_plan_arrays(self.parts, bp=self.bp,
                                      kcompact=self.kcompact,
                                      force_rdma=force_rdma)
            check(len(arrays["perms"]) == max(pre_topo.nphases, 1),
                  "phase coloring changed across the relabel (%d -> %d "
                  "phases)", pre_topo.nphases, len(arrays["perms"]))
        else:
            missing = [k for k in PLAN_KEYS if k not in arrays]
            check(not missing, "plan arrays lack %s", missing)
            self.parts = list(parts)
            self.bp = int(arrays["bp"])
            self.kcompact = None          # decided by the arrays' source
        self._load(arrays)

    def _load(self, a: dict) -> None:
        P = len(self.parts)
        self.ndev = int(a["ndev"])
        self.s_max = int(a["s_max"])
        self.ghost_start = int(a["ghost_start"])
        self.perms = [tuple(p) for p in a["perms"]]
        self.nphases = len(self.perms)
        # moves: some phase carries data (P > 1); without it the exchange
        # is skipped, as the reference skips phases with an empty perm.
        # has_comm: overlap runs the fused kernel (moves, or force_rdma)
        self.moves = any(len(p) for p in self.perms)
        self.has_comm = bool(a["has_comm"])
        self.locmap = [np.asarray(m, np.int64) for m in a["locmap"]]
        check(len(self.locmap) == P, "locmap for %d shards, model has %d",
              len(self.locmap), P)
        for p, m in zip(self.parts, self.locmap):
            check(m.shape == (p.npoint,), "locmap covers %d points, shard "
                  "%d has %d", m.shape[0], p.part_id, p.npoint)
        check(self.ndev % self.bp == 0, "ndev %d not a multiple of bp %d",
              self.ndev, self.bp)
        check(self.ghost_start + self.nphases * self.s_max <= self.ndev,
              "ghost regions overrun ndev %d", self.ndev)
        exch = (P, self.nphases, self.s_max)
        for k in ("send_idx", "send_mask", "pack_scale"):
            check(np.shape(a[k]) == exch, "%s shape %s, expected %s", k,
                  np.shape(a[k]), exch)

        def dev(x, dtype):
            return torch.tensor(np.ascontiguousarray(x, dtype),
                                device=self.device)

        # the static push map: host int32 for the fused kernel (checked on
        # the host there), device int64 for the loopback transport
        self.dsts = torch.tensor(np.asarray(a["dsts"], np.int32))
        self.srcs = torch.tensor(np.asarray(a["srcs"], np.int32))
        self.dst_index = self.dsts.long().to(self.device)
        # pack: buf[p, k, r, j] = g[p, r, send_idx[p, k, j]] * scale
        self.pack_cols = dev(a["send_idx"], np.int64)[:, :, None, :]
        self.send_mask = dev(a["send_mask"], np.float32)[:, :, None, :]
        self.pack_scale = dev(a["pack_scale"], np.float32)[:, :, None, :]
        self.pack_shard = torch.arange(P, device=self.device).view(P, 1, 1, 1)
        self.pack_row = torch.arange(ROWS, device=self.device).view(
            1, 1, ROWS, 1)

        self.plans: dict[str, dict[str, torch.Tensor]] = {}
        self.wks: dict[str, tuple[int, ...]] = {}
        for c in CLASSES:
            ca = a["classes"][c]
            missing = [k for k in CLASS_KEYS if k not in ca]
            check(not missing, "class %s arrays lack %s", c, missing)
            wks = tuple(int(w) for w in ca["wks"])
            bids = np.asarray(ca["block_ids"])
            check(bids.ndim == 2 and bids.shape[0] == P
                  and (np.diff(bids, axis=1) >= 0).all(),
                  "class %s block lists must be (P, nb), ascending with "
                  "trailing pad repeats", c)
            pl = {"block_ids": dev(bids, np.int32),
                  "src_cols": dev(ca["src_cols"], np.int32),
                  "slot_w": dev(ca["slot_w"], np.float32),
                  "scale": dev(ca["scale"], np.float32),
                  "slots": dev(slot_table(wks), np.int32)}
            check(pl["src_cols"].shape[2] == sum(wks) ==
                  pl["slot_w"].shape[3], "class %s compact length mismatch: "
                  "src_cols %d, Σwks %d, slot_w %d", c,
                  pl["src_cols"].shape[2], sum(wks), pl["slot_w"].shape[3])
            self.plans[c] = pl
            self.wks[c] = wks

    @classmethod
    def from_arrays(cls, parts: list[MeshPartition], nvar: int,
                    arrays: dict, *,
                    device: str | torch.device = "cuda") -> "GreenGaussTorch":
        """Build from another model's plan arrays (convert.plans_from_jax)
        and its relabeled partitions — both packages then compute on
        identical plan data."""
        return cls(parts, nvar, device=device, arrays=arrays)

    # ------------------------------------------------------------- state

    @staticmethod
    def classes_for(schedules) -> tuple[str, ...]:
        """Table classes a set of schedules reads (None → all three)."""
        if schedules is None:
            return CLASSES
        need = set()
        for s in schedules:
            check(s in SCHEDULE_CLASSES, "unknown schedule %r", s)
            need.update(SCHEDULE_CLASSES[s])
        return tuple(c for c in CLASSES if c in need)

    def distribute_state(self, gvar: np.ndarray, *,
                         schedules=None) -> dict:
        """Global (N, nvar) host state → {"var_T": (P, NV, ndev) f32,
        "tables": {class: (P, nb, NV, L) f32 packed sources}} for the
        classes the given schedules read (default: all).  Ghost var values
        are filled host-side: the state is static across the benchmark
        loop, the exchange moves gradients."""
        check(gvar.shape[1] == self.nvar, "state has %d vars, model %d",
              gvar.shape[1], self.nvar)
        host = np.zeros((len(self.parts), NV, self.ndev), np.float32)
        for i, (p, m) in enumerate(zip(self.parts, self.locmap)):
            host[i][: self.nvar, m] = gvar[p.global_ids].T
        var_T = torch.from_numpy(host).to(self.device)
        tables = {c: pack_srcs(var_T, self.plans[c]["src_cols"])
                  for c in self.classes_for(schedules)}
        return {"var_T": var_T, "tables": tables}

    # ------------------------------------------------------------- steps

    def check_schedule(self, schedule: str, tables: dict) -> None:
        check(schedule in SCHEDULE_CLASSES, "unknown schedule %r (the "
              "port runs %s)", schedule, "/".join(SCHEDULES))
        need = SCHEDULE_CLASSES[schedule]
        check(all(c in tables for c in need),
              "state carries table classes %s but schedule %r needs %s — "
              "distribute_state(schedules=...) must include it",
              sorted(tables), schedule, need)

    def _sweep(self, cls: str, var_T, tables, init=None):
        pl = self.plans[cls]
        return sweep_blocks(var_T, tables[cls], pl["slot_w"], pl["scale"],
                            pl["block_ids"], pl["slots"], init=init)

    def _pack(self, g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """(P, 3·NV, ndev) → (P, nph, 3·NV, s_max) send buffers: the
        columns of send_idx, times the mask (bulk: gradients are already
        volume-scaled) or pack_scale (early/overlap: boundary sums are
        not)."""
        return g[self.pack_shard, self.pack_row, self.pack_cols] * scale

    def _unpack(self, g: torch.Tensor, recv: torch.Tensor) -> None:
        """Phase k's buffers into its ghost region [ghost_start + k·s_max,
        +s_max): the regions are adjacent, so one strided copy."""
        P, nph = recv.shape[:2]
        lo = self.ghost_start
        g[:, :, lo:lo + nph * self.s_max].view(
            P, ROWS, nph, self.s_max).copy_(recv.permute(0, 2, 1, 3))

    def forward(self, var_T: torch.Tensor, tables: dict,
                schedule: str = "bulk") -> torch.Tensor:
        """One step → (P, 3·NV, ndev) gradients, row d*NV+v, ghost columns
        filled from their owners (except under nocomm)."""
        if schedule in ("bulk", "nocomm"):
            g = self._sweep("bulk", var_T, tables)
            if schedule == "bulk" and self.moves:
                self._unpack(g, loopback(self._pack(g, self.send_mask),
                                         self.dst_index))
            return g
        zeros = torch.zeros((len(self.parts), ROWS, self.ndev),
                            dtype=torch.float32, device=self.device)
        gb = self._sweep("boundary", var_T, tables, init=zeros)
        if schedule == "overlap" and self.has_comm:
            pl = self.plans["interior"]
            g, recv = sweep_blocks_overlap(
                var_T, tables["interior"], pl["slot_w"], pl["scale"],
                pl["block_ids"], pl["slots"], gb,
                self._pack(gb, self.pack_scale), self.dsts, self.srcs)
            self._unpack(g, recv)
            return g
        # early, or overlap with nothing to move: start the exchange, sweep
        # the interior onto the boundary sums, finish the exchange
        recv = (loopback(self._pack(gb, self.pack_scale), self.dst_index)
                if self.moves else None)
        g = self._sweep("interior", var_T, tables, init=gb)
        if recv is not None:
            self._unpack(g, recv)
        return g

    def iter_args(self, state: dict) -> tuple:
        return state["var_T"], state["tables"]

    def step(self, state: dict, schedule: str = "bulk") -> torch.Tensor:
        self.check_schedule(schedule, state["tables"])
        return self(state["var_T"], state["tables"], schedule)

    def iterate_fn(self, schedule: str, n: int):
        """Chained n-step runner over iter_args: each step's gradients feed
        the next step's state (v + 1e-30·g[:, :NV], the reference's chained
        loop), so no step can be skipped; returns the final var_T."""

        def run(var_T, tables):
            self.check_schedule(schedule, tables)
            v = var_T
            for _ in range(n):
                g = self(v, tables, schedule)
                v = v + 1e-30 * g[:, :NV]
            return v

        return run

    # ------------------------------------------------------------ gather

    def gather_global(self, grad: torch.Tensor) -> np.ndarray:
        """(P, 3·NV, ndev) device gradients → global (N, nvar*3) host array,
        column v*3+d (the reference's convention)."""
        arr = grad.detach().cpu().numpy()
        N = sum(p.nowned for p in self.parts)
        out = np.zeros((N, self.nvar * 3), dtype=arr.dtype)
        for i, p in enumerate(self.parts):
            gids = p.global_ids[: p.nowned]
            for v in range(self.nvar):
                for d in range(3):
                    out[gids, v * 3 + d] = arr[i, d * NV + v, : p.nowned]
        return out

