"""GreenGaussTorch — the port's block-sweep model, and PSDFluxModel.

Counterpart of `cfd_proxy_tpu/models/gradients_pallas.py::GreenGaussPallas`
and its `PSDFluxModel` (op "gg", Green-Gauss gradients, or op "flux", the
PSD upwind flux of ops/flux.py; packed or gather kernel; f32, or the
reduced-precision options below) for P shards held on ONE device, or
spread over the W ranks of a `torch.distributed` group, each rank holding
P/W shards on its own device:

- `__init__`: block-size rule, RCB locality relabel (+ in-block degree sort
  for the compact prefix widths), halo topology, transposed device layout,
  the bulk / boundary / interior BlockPlans of every shard padded to common
  shapes, pack-time scaling and the prefix widths — the reference's host
  construction, step for step, so both packages hold identical plan data.
  The packed kernel keeps each class's compact tables, the gather kernel
  its rectangular W-index and weight tables and ext lists;
- `distribute_state`: host state → stacked (P, NV, ndev) `var_T` + the
  table of each class the requested schedules read: packed sources
  (`pack_srcs` kernel) or ext columns (`gather_exts`);
- `step(state, s)` for s in bulk / early / overlap / nocomm (`sweep_blocks`
  or `sweep_blocks_gather`, with and without init; the fused
  `sweep_blocks_overlap` / `sweep_blocks_overlap_gather` for overlap);
- `refresh_state(var_T)`: the solver-mode state update — var halo exchange
  and a rebuild of the tables;
- `iterate_fn(s, n, solver_mode, sweeps_per_step, graph=None)`: the
  chained n-step loop the timing uses, or the solver's per-step dataflow
  (table rebuild, N sweeps with their updates, var exchange), on the step
  bodies `chain_body` / `solver_body`; replayed as CUDA graphs where
  `compiled.dispatch` says so (models/compiled.py), else eager;
- `gather_global`: gg device rows d*NV+v → global (N, nvar*3) column
  v*3+d; flux rows v → global (N, nvar).

The halo exchange: phase k's buffer of shard p lands in phase k's ghost
region of shard dsts[p, k]; the same path moves the sweep's output (3·NV
gradient rows or NV flux rows) and, in solver mode, the state (NV rows).
How the buffers travel is the transport's business
(parallel/transport.py): `loopback` (every shard in this process: one
indexed copy; the only choice at W = 1 besides `peer`), `dist`
(`batch_isend_irecv` between ranks, started before the interior sweep and
finished after it under `early`), or `peer` (the ranks map each other's
receive buffers, and under `overlap` the fused kernel stores into them
from inside its launch, behind a readiness barrier; every other exchange
of a `peer` model rides `dist`, or `loopback` at W = 1, as the reference's
bulk and early steps ride ppermute).  The reference's ppermute moves only
the pairs of layout.perms[k] and leaves other receivers zero, and so does
`dist`; `loopback` and the kernels move the completed permutation (dsts),
whose extra pairs carry send-masked zeros, so the ghost regions come out
the same.  Pack and unpack are plain torch ops, as they are XLA ops in the
reference.

Routing (`slice_size`, the reference's `_ici_phases` / `_dcn_phases`):
devices [k·slice_size, (k+1)·slice_size) form a node, and the topology
colors the pairs that cross nodes into phases of their own
(`inter_slice`).  Under `overlap` the fused kernel carries only the phases
inside a node; the others are packed, posted on the collective transport
before the fused kernel and unpacked after it.  With no phase left for the
kernel (every phase crosses nodes, or the transport is `dist`) overlap
runs the early graph.

Every rank builds the whole host plan (the per-class pad dims and prefix
widths need all shards; the construction is deterministic, so ranks
agree) and keeps its own slice [lo, hi) of every stacked array on its
device: set-up memory is not yet rank-local, device memory is.

Reduced precision, the reference's four options, each "float32" or
"bfloat16": `meta_dtype` stores the slot weights in bf16 (rounded here from
the f32 plan, to nearest even, as the reference's `astype`); `src_dtype`
packs bf16 DELTAS src − own (packed kernel only); `grad_dtype` stores every
gradient buffer in bf16 (outputs, the boundary partial),
while the kernels accumulate in f32; `halo_dtype` casts the GRADIENT
exchange's send buffers at pack time (the var exchange stays f32) and the
unpack casts back into the output's dtype.  The state `var_T` is f32 in
every mode.

The fake exchange phases (`min_phases`, `fake_sends`, `fake_tail_frac`,
benchmark-only) pad the schedule with self-send phases that move real
payloads through pack, transport, the fused kernel's push and unpack, so
one shard measures a P > 1-shaped exchange.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from cfd_proxy_tpu_torch.mesh.model import MeshPartition
from cfd_proxy_tpu_torch.mesh.partition import (
    rcb_owned_order,
    relabel_owned,
    send_point_set,
)
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.compiled import COUPLING
from cfd_proxy_tpu_torch.ops.blocksweep import (
    BF16,
    F32,
    OPS,
    direct_sources,
    ext_counts,
    gather_exts,
    out_rows,
    pack_srcs,
    slot_table,
    sweep_blocks,
    sweep_blocks_gather,
    sweep_blocks_overlap,
    sweep_blocks_overlap_gather,
    table_lanes_per_column,
)
from cfd_proxy_tpu_torch.ops.plan import (
    NV,
    _pad_blocks,
    _pad_plan_dims,
    build_block_plan,
    compact_slot_w,
    compact_src_cols,
    compact_widx,
    prefix_widths,
)
from cfd_proxy_tpu_torch.ops.update import chain_update
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
from cfd_proxy_tpu_torch.parallel.transport import (
    TRANSPORTS,
    Dist,
    Loopback,
    Peer,
    gather_shards,
    group_size,
    shard_range,
)
from cfd_proxy_tpu_torch.utils import spans
from cfd_proxy_tpu_torch.utils.errors import check

# AUTO block-size rule (bp=None), kept from the reference so that both
# packages build the same layout; it is to be re-decided on the GPU.
BP_AUTO_SMALL = 262144
BP_SMALL = 1024
CLASSES = ("bulk", "boundary", "interior")
SWEEP_SPANS = {c: "sweep." + c for c in CLASSES}    # utils/spans.py
KERNELS = ("packed", "gather")
SCHEDULES = ("bulk", "early", "overlap", "nocomm")
# the reduced-precision options and the stored types they name
PRECISIONS = {"float32": F32, "bfloat16": BF16}
DTYPE_OPTIONS = ("meta_dtype", "src_dtype", "halo_dtype", "grad_dtype")
# which source-table classes each schedule's step reads
SCHEDULE_CLASSES = {
    "bulk": ("bulk",), "nocomm": ("bulk",),
    "early": ("boundary", "interior"), "overlap": ("boundary", "interior"),
}
# the host arrays `from_arrays` takes (see convert.plans_from_jax);
# "classes" maps each class to a dict of CLASS_KEYS[kernel]
PLAN_KEYS = ("kernel", "ndev", "bp", "s_max", "ghost_start", "locmap",
             "send_idx", "send_mask", "pack_scale", "dsts", "srcs", "perms",
             "has_comm", "classes")
# optional: (nphases,) bool, phases that cross nodes (absent: none does)
OPTIONAL_PLAN_KEYS = ("inter_slice",)
CLASS_KEYS = {
    # compact tables: src_cols (P, nb, L), slot_w (P, nb, 3, L), and what
    # the pack kernel stages and resolves: widx (P, nb, L), ext_idx
    # (P, nb, ep)
    "packed": ("block_ids", "src_cols", "widx", "ext_idx", "slot_w", "scale",
               "wks"),
    # rectangular tables: slot_idx (P, nb, K, bp), slot_w (P, nb, K, 3, bp),
    # ext_idx (P, nb, ep)
    "gather": ("block_ids", "slot_idx", "slot_w", "ext_idx", "ep", "scale",
               "wks"),
}
# the plan operands a class's sweep takes after its table
SWEEP_OPERANDS = {
    "packed": ("slot_w", "scale", "block_ids", "slots"),
    "gather": ("slot_idx", "slot_w", "scale", "block_ids", "slots"),
}


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
                     force_rdma: bool = False, kernel: str = "packed",
                     slice_size: int | None = None, min_phases: int = 1,
                     fake_sends: int = 0, fake_tail_frac: float = 0.0
                     ) -> dict:
    """Layout, exchange tables and the three class plans of RELABELED
    shards as host arrays (PLAN_KEYS), built exactly as
    `GreenGaussPallas.__init__` builds them (gradients_pallas.py:349-542).
    Each class keeps only the tables its kernel reads (CLASS_KEYS): at the
    benchmark size either set runs to hundreds of MB.  min_phases,
    fake_sends, fake_tail_frac: the fake exchange phases
    (`build_tlayout`)."""
    npoint_pad = max(p.npoint for p in parts) + 1
    topo = build_halo_topology(parts, npoint_pad, slice_size=slice_size)
    lay = build_tlayout(parts, topo, bp=bp, min_phases=min_phases,
                        fake_sends=fake_sends, fake_tail_frac=fake_tail_frac)
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
        ca = {"block_ids": np.stack([pl.block_ids for pl in padded]),
              "scale": np.stack([pl.scale for pl in padded]), "wks": wks}
        if kernel == "gather":
            ca.update(slot_idx=np.stack([pl.slot_idx for pl in padded]),
                      slot_w=sw, ep=ep,
                      ext_idx=np.stack([pl.ext_idx for pl in padded]))
        else:
            ca.update(src_cols=np.stack([compact_src_cols(pl, wks)
                                         for pl in padded]),
                      widx=np.stack([compact_widx(pl, wks) for pl in padded]),
                      ext_idx=np.stack([pl.ext_idx for pl in padded]),
                      slot_w=compact_slot_w(sw, wks))
        classes[c] = ca
    return {
        "kernel": kernel, "ndev": lay.ndev, "bp": bp, "s_max": lay.s_max,
        "ghost_start": lay.ghost_start, "locmap": lay.locmap,
        "send_idx": lay.send_idx, "send_mask": lay.send_mask,
        "pack_scale": pack_scale, "dsts": lay.dsts, "srcs": lay.srcs,
        "perms": lay.perms, "inter_slice": lay.inter_slice,
        # overlap runs the fused kernel only when a phase moves data, or
        # when forced (P=1: self-sends of masked zeros); else it is early
        "has_comm": any(len(p) for p in lay.perms) or force_rdma,
        "classes": classes,
    }


def _check_range(idx: np.ndarray, hi: int, name: str) -> None:
    """Every index in [0, hi): the kernels load through them unchecked."""
    check(idx.size == 0 or (idx.min() >= 0 and idx.max() < hi),
          "%s outside [0, %d)", name, hi)


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
    """Block sweep (Green-Gauss gradients or, op "flux", the upwind flux) +
    halo exchange of P shards on one device, or of this rank's P/W shards
    among the W ranks of a process group."""

    def __init__(self, parts: list[MeshPartition], nvar: int, *,
                 bp: int | None = None, kcompact: bool | None = None,
                 force_rdma: bool = False, kernel: str = "packed",
                 op: str = "gg", device: str | torch.device = "cuda",
                 meta_dtype: str = "float32", src_dtype: str = "float32",
                 halo_dtype: str = "float32", grad_dtype: str = "float32",
                 arrays: dict | None = None, group=None,
                 transport: str | None = None,
                 slice_size: int | None = None, share_device: bool = False,
                 min_phases: int = 1, fake_sends: int = 0,
                 fake_tail_frac: float = 0.0):
        """parts: the raw partitions (relabeled here, as the reference
        does), or — with `arrays` — partitions ALREADY relabeled by the
        model the arrays come from (see `from_arrays`).  kernel: "packed"
        (sources packed ahead of the sweep, K4 + K1) or "gather" (the sweep
        gathers them from per-block ext tables, K2).  op: "gg" (3·NV output
        rows) or "flux" (NV rows); the plans do not depend on it.
        meta_dtype, src_dtype, halo_dtype, grad_dtype: "float32" or
        "bfloat16" (module docstring); bf16 sources need the packed
        kernel.  group: the `torch.distributed` group whose W ranks share
        the shards (W divides P; None: this process holds them all), every
        rank building the model with the same arguments.  transport:
        "loopback" (W = 1 only), "dist" or "peer" (module docstring;
        default loopback at W = 1, else dist).  slice_size: devices per
        node, for the phase routing (ignored with `arrays`, which carry
        their own).  share_device: several ranks sit on this device (nccl
        cannot run so, and says so here).  min_phases, fake_sends,
        fake_tail_frac (benchmark-only; with `arrays`, the fake_sends they
        were built with): pad the exchange schedule to min_phases phases,
        and give each padded phase a real payload of fake_sends owned
        columns sent to the shard itself (its last fake_tail_frac packed
        from strided columns); the payload lands in the padded phase's
        ghost region, which no face reads, so owned results are unchanged
        (`build_tlayout`)."""
        super().__init__()
        self.graphs = collections.OrderedDict()   # captured steps (compiled)
        self.group = group
        self.rank, self.world = group_size(group)
        self.lo, self.hi = shard_range(len(parts), self.rank, self.world)
        self.nlocal = self.hi - self.lo
        if transport is None:
            transport = "loopback" if self.world == 1 else "dist"
        check(transport in TRANSPORTS, "unknown transport %r (one of %s)",
              transport, "/".join(TRANSPORTS))
        check(transport != "loopback" or self.world == 1, "the loopback "
              "transport holds every shard in one process; %d ranks need "
              "dist or peer", self.world)
        self.transport_kind = transport
        self.share_device = bool(share_device)
        for name, value in (("meta_dtype", meta_dtype),
                            ("src_dtype", src_dtype),
                            ("halo_dtype", halo_dtype),
                            ("grad_dtype", grad_dtype)):
            check(value in PRECISIONS, "%s must be float32|bfloat16, got %r",
                  name, value)
        # the reference's check (gradients_pallas.py:205-206): the gather
        # formulation reads the f32 state tables inside the sweep
        check(src_dtype == "float32" or
              (kernel if arrays is None else arrays.get("kernel")) ==
              "packed", "--src-dtype bfloat16 requires the packed kernel")
        self.meta_dtype, self.src_dtype = meta_dtype, src_dtype
        self.halo_dtype, self.grad_dtype = halo_dtype, grad_dtype
        self.src_format = "bf16d" if src_dtype == "bfloat16" else "f32"
        # stored types: weights, gradient buffers, gradient wire
        self.w_t = PRECISIONS[meta_dtype]
        self.grad_t = PRECISIONS[grad_dtype]
        self.halo_t = PRECISIONS[halo_dtype]
        check(op in OPS, "unknown kernel op %r", op)
        check(1 <= nvar <= NV, "nvar %d outside [1, %d]", nvar, NV)
        # the flux reads var[:3] as the velocity vector (the reference's
        # check, gradients_pallas.py:284-285)
        check(op != "flux" or nvar >= 3,
              "flux model needs nvar >= 3 (velocity components), got %d",
              nvar)
        check(kernel in KERNELS, "unknown kernel formulation %r (one of %s)",
              kernel, "/".join(KERNELS))
        self.op = op
        self.rows = out_rows(op)
        self.nvar = int(nvar)
        self.device = torch.device(device)
        check(min_phases >= 1 and fake_sends >= 0, "min_phases %d must be "
              ">= 1 and fake_sends %d >= 0", min_phases, fake_sends)
        # build_tlayout ignores the tail fraction without fake lanes: the
        # pair is refused rather than run as if it did something
        check(fake_tail_frac == 0.0 or fake_sends > 0, "fake_tail_frac %s "
              "needs fake_sends > 0 (it carves the fake phases' lanes)",
              fake_tail_frac)
        # the schedules' ghost regions of fake phases differ by design
        # (solver.verify_model compares owned columns when this is set)
        self.fake_sends = int(fake_sends)
        if arrays is None:
            self.kcompact = True if kcompact is None else bool(kcompact)
            self.bp = auto_bp(parts, bp)
            # pre-topology on the raw parts: phase ids for the comm-first
            # grouping of the relabel (the relabel keeps the comm graph, so
            # the final topology has the same phases)
            pre_topo = build_halo_topology(parts,
                                           max(p.npoint for p in parts) + 1,
                                           slice_size=slice_size)
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
                                      force_rdma=force_rdma, kernel=kernel,
                                      slice_size=slice_size,
                                      min_phases=min_phases,
                                      fake_sends=fake_sends,
                                      fake_tail_frac=fake_tail_frac)
            check(len(arrays["perms"]) == max(pre_topo.nphases, 1,
                                              min_phases),
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
        self.kernel = a["kernel"]
        check(self.kernel in KERNELS, "plan arrays for kernel %r (one of %s)",
              self.kernel, "/".join(KERNELS))
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
        lo, hi, n = self.lo, self.hi, self.nlocal

        def dev(x, dtype):
            """This rank's slice [lo, hi) of a stacked (P, ...) array."""
            return torch.tensor(np.ascontiguousarray(np.asarray(x)[lo:hi],
                                                     dtype),
                                device=self.device)

        # the static push map over ALL shards, host int32 (the transports
        # and the fused kernel's wrapper check it on the host)
        self.dsts = torch.tensor(np.asarray(a["dsts"], np.int32))
        self.srcs = torch.tensor(np.asarray(a["srcs"], np.int32))
        inter = np.asarray(a.get("inter_slice", np.zeros(self.nphases)), bool)
        check(inter.shape == (self.nphases,), "inter_slice shape %s, "
              "expected (%d,)", inter.shape, self.nphases)
        # the reference's _ici_phases / _dcn_phases
        self.ici_phases = [k for k in range(self.nphases) if not inter[k]]
        self.dcn_phases = [k for k in range(self.nphases) if inter[k]]
        self._load_transports()
        # pack: buf[p, k, r, j] = g[p, r, send_idx[p, k, j]] * scale
        self.pack_cols = dev(a["send_idx"], np.int64)[:, :, None, :]
        self.send_mask = dev(a["send_mask"], np.float32)[:, :, None, :]
        # this rank's live send columns over every phase (halo_live_bytes)
        self.live_cols = int(np.count_nonzero(
            np.asarray(a["send_mask"])[lo:hi]))
        self.pack_scale = dev(a["pack_scale"], np.float32)[:, :, None, :]
        self.pack_shard = torch.arange(n, device=self.device).view(n, 1, 1, 1)
        # sized for the most rows any exchange moves (3·NV gradients)
        self.pack_row = torch.arange(3 * NV, device=self.device).view(
            1, 1, 3 * NV, 1)

        self.plans: dict[str, dict[str, torch.Tensor]] = {}
        self.wks: dict[str, tuple[int, ...]] = {}
        # a gather class's choice of the direct body's sources, made here
        # once (blocksweep.direct_sources)
        self.sources: dict[str, str] = {}
        for c in CLASSES:
            ca = a["classes"][c]
            missing = [k for k in CLASS_KEYS[self.kernel] if k not in ca]
            check(not missing, "class %s arrays lack %s", c, missing)
            wks = tuple(int(w) for w in ca["wks"])
            bids = np.asarray(ca["block_ids"])
            check(bids.ndim == 2 and bids.shape[0] == P
                  and (np.diff(bids, axis=1) >= 0).all(),
                  "class %s block lists must be (P, nb), ascending with "
                  "trailing pad repeats", c)
            pl = {"block_ids": dev(bids, np.int32),
                  "slot_w": self._weights(c, ca["slot_w"], dev),
                  "scale": dev(ca["scale"], np.float32),
                  "slots": torch.tensor(slot_table(wks), device=self.device)}
            if self.kernel == "gather":
                pl.update(self._gather_tables(c, ca, wks, bids.shape[1], dev))
                self.sources[c] = direct_sources(
                    self.bp, int(ca["ep"]), table_lanes_per_column(
                        pl["slot_w"], pl["block_ids"], wks, pl["ext_cnt"]))
            else:
                pl.update(self._packed_tables(c, ca, wks, bids.shape[1],
                                              pl["slot_w"].shape[3], dev))
            self.plans[c] = pl
            self.wks[c] = wks

    def _load_transports(self) -> None:
        """The exchange's carriers (module docstring).  `transport`: every
        phase, for bulk, early and the state.  Under overlap the fused
        kernel carries `kernel_phases` (through `peer`, or inside its own
        launch) and `coll` carries `coll_phases`."""
        perms, dsts = self.perms, self.dsts.numpy()

        def carrier(phases):
            if self.world == 1:
                return Loopback(dsts[:, phases], self.device)
            return Dist([perms[k] for k in phases], len(self.parts),
                        self.group, self.device, self.share_device)

        every = list(range(self.nphases))
        self.transport = carrier(every)
        in_kernel = self.transport_kind in ("loopback", "peer")
        self.kernel_phases = list(self.ici_phases) if in_kernel else []
        self.coll_phases = [k for k in every if k not in self.kernel_phases]
        # all phases in the kernel (no slice_size): today's single launch
        self.routed = bool(self.kernel_phases) and bool(self.coll_phases)
        self.coll = carrier(self.coll_phases) if self.routed else None
        # the routed split's phase indices on the device (a list index
        # would be copied from the host at every step, which a captured
        # step cannot do)
        self.coll_index, self.kernel_index = (
            torch.tensor(ph, dtype=torch.int64, device=self.device)
            for ph in (self.coll_phases, self.kernel_phases))
        # the fused kernel's push map: the in-kernel phases' columns
        self.kernel_map = (
            (self.dsts[:, self.kernel_phases].contiguous(),
             self.srcs[:, self.kernel_phases].contiguous())
            if self.routed else (self.dsts, self.srcs))
        self.peer = None
        if self.transport_kind == "peer":
            check(self.device.type == "cuda", "the peer transport maps "
                  "device memory between ranks and has no CPU form (use "
                  "--transport dist on the CPU)")
            if self.kernel_phases and self.has_comm:
                sel = self.kernel_phases
                self.peer = Peer(dsts[:, sel], self.srcs.numpy()[:, sel],
                                 rows=self.rows, s_max=self.s_max,
                                 dtype=self.halo_t, device=self.device,
                                 group=self.group)
        self.transport_name = (
            "peer+" + self.transport.name if self.transport_kind == "peer"
            else self.transport.name)

    def close(self) -> None:
        """Free the captured step graphs and release the peer transport's
        mapped memory (collective over the group; a no-op for the other
        transports)."""
        self.graphs.clear()
        if self.peer is not None:
            self.peer.close()
            self.peer = None

    def _weights(self, c: str, w, dev) -> torch.Tensor:
        """A class's slot weights on the device in the meta dtype: f32 host
        weights are rounded here (to nearest even, as the reference's
        `astype(bfloat16)`); bf16 weights, which another model's plan
        arrays may carry as a torch tensor (convert.plans_from_jax), are
        taken as they are, and only by a bf16-weight model."""
        if isinstance(w, torch.Tensor):
            check(w.dtype in (F32, BF16), "class %s slot_w dtype %s", c,
                  w.dtype)
            check(w.dtype == F32 or self.w_t == BF16, "class %s slot_w is "
                  "bf16: build the model with meta_dtype='bfloat16'", c)
            w = w[self.lo:self.hi].to(self.device)
        else:
            w = dev(w, np.float32)
        return w.to(self.w_t).contiguous()

    def _gather_tables(self, c: str, ca: dict, wks: tuple, nb: int,
                       dev) -> dict:
        """A gather class's W-index table, ext lists and live ext counts
        (`ext_counts`), range-checked here once (the kernel reads var_T,
        the ext table and its staged copy through them)."""
        P, K, bp, ep = len(self.parts), len(wks), self.bp, int(ca["ep"])
        sidx, ext = np.asarray(ca["slot_idx"]), np.asarray(ca["ext_idx"])
        for name, arr, want in (
                ("slot_idx", sidx, (P, nb, K, bp)),
                ("slot_w", ca["slot_w"], (P, nb, K, 3, bp)),
                ("ext_idx", ext, (P, nb, ep))):
            check(np.shape(arr) == want, "class %s %s shape %s, expected %s",
                  c, name, np.shape(arr), want)
        _check_range(sidx, bp + ep, f"class {c} slot_idx")
        _check_range(ext, self.ndev, f"class {c} ext_idx")
        # ext_idx as the int64 index gather_exts uses on every rebuild; the
        # live ext columns per entry, which the staged sweep body stages
        return {"slot_idx": dev(sidx, np.int32), "ext_idx": dev(ext, np.int64),
                "ext_cnt": dev(ext_counts(sidx, bp), np.int32)}

    def _packed_tables(self, c: str, ca: dict, wks: tuple, nb: int, nw: int,
                       dev) -> dict:
        """A packed class's source columns (the pack's plain version), and
        its compact W-index and ext lists (the pack kernel's staging),
        range-checked here once (the kernel reads var_T and shared memory
        through them)."""
        P, L = len(self.parts), sum(wks)
        cols, widx = np.asarray(ca["src_cols"]), np.asarray(ca["widx"])
        ext = np.asarray(ca["ext_idx"])
        check(L == nw, "class %s compact length mismatch: Σwks %d, slot_w "
              "%d", c, L, nw)
        for name, arr in (("src_cols", cols), ("widx", widx)):
            check(arr.shape == (P, nb, L), "class %s %s shape %s, expected "
                  "%s", c, name, arr.shape, (P, nb, L))
        check(ext.ndim == 3 and ext.shape[:2] == (P, nb), "class %s ext_idx "
              "shape %s, expected (%d, %d, ep)", c, ext.shape, P, nb)
        _check_range(cols, self.ndev, f"class {c} src_cols")
        _check_range(widx, self.bp + ext.shape[2], f"class {c} widx")
        _check_range(ext, self.ndev, f"class {c} ext_idx")
        return {"src_cols": dev(cols, np.int32), "widx": dev(widx, np.int32),
                "ext_idx": dev(ext, np.int32)}

    @classmethod
    def from_arrays(cls, parts: list[MeshPartition], nvar: int,
                    arrays: dict, *, device: str | torch.device = "cuda",
                    **options) -> "GreenGaussTorch":
        """Build from another model's plan arrays (convert.plans_from_jax)
        and its relabeled partitions — both packages then compute on
        identical plan data.  options: the dtype options of `__init__`."""
        return cls(parts, nvar, device=device, arrays=arrays, **options)

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
        "tables": {class: table}} for the classes the given schedules read
        (default: all); a table is the (P, nb, NV, L) packed sources or the
        (P, nb, NV, EP) ext columns.  Ghost var values are filled host-side:
        the state is static across the benchmark loop, the exchange moves
        gradients."""
        check(gvar.shape[1] == self.nvar, "state has %d vars, model %d",
              gvar.shape[1], self.nvar)
        host = np.zeros((self.nlocal, NV, self.ndev), np.float32)
        for i in range(self.nlocal):
            p, m = self.parts[self.lo + i], self.locmap[self.lo + i]
            host[i][: self.nvar, m] = gvar[p.global_ids].T
        var_T = torch.from_numpy(host).to(self.device)
        return {"var_T": var_T,
                "tables": self._build_tables(var_T,
                                             self.classes_for(schedules))}

    def _build_tables(self, var_T: torch.Tensor, classes) -> dict:
        """Each class's table from the state, in span "rebuild": packed
        sources (`pack_srcs` kernel) or ext columns (`gather_exts`, a plain
        gather)."""
        with spans.span("rebuild", self.device):
            if self.kernel == "gather":
                return {c: gather_exts(var_T, self.plans[c]["ext_idx"])
                        for c in classes}
            return {c: pack_srcs(var_T, self.plans[c]["src_cols"],
                                 src_format=self.src_format, bp=self.bp,
                                 **self.pack_operands(c))
                    for c in classes}

    def pack_operands(self, c: str) -> dict:
        """The plan operands `pack_srcs` takes for class c beside var_T,
        src_cols and bp: block_ids, slots, widx, ext_idx."""
        pl = self.plans[c]
        return {k: pl[k] for k in ("block_ids", "slots", "widx", "ext_idx")}

    def _var_exchange(self, var_T: torch.Tensor) -> torch.Tensor:
        """Refresh every ghost var column from its owner, IN PLACE: the
        owners' columns by send_idx × send_mask (no scale), through the
        collective transport, into the static ghost regions, rows 0..NV-1.
        Skipped when no phase moves data, as the reference skips phases
        with an empty perm.  One span, "var_exchange", holds its device
        time, its pack and unpack included."""
        if self.moves:
            with spans.span("var_exchange", self.device, leaf=True):
                self._exchange(var_T, self.send_mask, F32)
        return var_T

    def refresh_state(self, var_T: torch.Tensor, *, schedules=None) -> dict:
        """Solver-mode state update: given a stacked var_T whose OWNED
        columns were updated on the device, redo the var halo exchange
        (ghost columns, written into var_T in place) and rebuild the tables
        of the classes the schedules read (default: all).  Returns the
        state dict `distribute_state` returns.  Counterpart of
        `GreenGaussPallas.refresh_state`."""
        check(tuple(var_T.shape) == (self.nlocal, NV, self.ndev)
              and var_T.dtype == torch.float32
              and var_T.device == self.device,
              "var_T must be (%d, %d, %d) f32 on %s, got %s %s on %s",
              self.nlocal, NV, self.ndev, self.device,
              tuple(var_T.shape), var_T.dtype, var_T.device)
        var_T = self._var_exchange(var_T)
        return {"var_T": var_T,
                "tables": self._build_tables(var_T,
                                             self.classes_for(schedules))}

    # ------------------------------------------------------------- steps

    def check_schedule(self, schedule: str, tables: dict) -> None:
        check(schedule in SCHEDULE_CLASSES, "unknown schedule %r (the "
              "port runs %s)", schedule, "/".join(SCHEDULES))
        need = SCHEDULE_CLASSES[schedule]
        check(all(c in tables for c in need),
              "state carries table classes %s but schedule %r needs %s — "
              "distribute_state(schedules=...) must include it",
              sorted(tables), schedule, need)

    def _operands(self, cls: str, tables: dict) -> tuple:
        """A class's table and plan operands, as its sweep takes them."""
        pl = self.plans[cls]
        return (tables[cls], *(pl[k] for k in SWEEP_OPERANDS[self.kernel]))

    def _gather_kw(self, cls: str) -> dict:
        """The gather sweeps' keyword operands: the class's live ext counts
        and its direct body's sources (none for the packed kernel)."""
        if self.kernel != "gather":
            return {}
        return {"ext_cnt": self.plans[cls]["ext_cnt"],
                "sources": self.sources[cls]}

    def _sweep(self, cls: str, var_T, tables, init=None):
        """A class's sweep, in span "sweep.<cls>"; its output (init's, else
        a new one) is stored in the grad dtype."""
        sweep = sweep_blocks_gather if self.kernel == "gather" else \
            sweep_blocks
        with spans.span(SWEEP_SPANS[cls], self.device):
            return sweep(var_T, *self._operands(cls, tables), init=init,
                         op=self.op, out_dtype=self.grad_t,
                         **self._gather_kw(cls))

    def _pack(self, x: torch.Tensor, scale: torch.Tensor,
              wire: torch.dtype = F32) -> torch.Tensor:
        """(P, rows, ndev) → (P, nph, rows, s_max) send buffers: the
        columns of send_idx, times the mask (bulk gradients, which are
        already volume-scaled, and the state) or pack_scale (early/overlap:
        boundary sums are not), in f32 (a bf16 x is widened by the
        product, as in the reference), then cast to the wire dtype.  In
        span "pack"; counts the bytes written (`halo_counters`)."""
        with spans.span("pack", self.device):
            rows = self.pack_row[:, :, : x.shape[1]]
            bufs = (x[self.pack_shard, rows, self.pack_cols] * scale).to(wire)
        size = bufs.element_size()
        count = GreenGaussTorch._pack
        count.halo_bytes += bufs.numel() * size
        count.halo_live_bytes += self.live_cols * x.shape[1] * size
        return bufs

    def _unpack(self, x: torch.Tensor, recv: torch.Tensor,
                phases: list | None = None) -> None:
        """Phase k's buffers into its ghost region [ghost_start + k·s_max,
        +s_max), cast into x's dtype.  Every phase (phases None): the
        regions are adjacent, so one strided copy; else recv holds the
        listed phases, each copied into its own region.  In span
        "unpack"."""
        P, nph, rows = recv.shape[:3]
        lo = self.ghost_start
        with spans.span("unpack", self.device):
            if phases is None:
                x[:, :, lo:lo + nph * self.s_max].view(
                    P, rows, nph, self.s_max).copy_(recv.permute(0, 2, 1, 3))
                return
            for j, k in enumerate(phases):
                x[:, :, lo + k * self.s_max:lo + (k + 1) * self.s_max].copy_(
                    recv[:, j])

    def _exchange(self, x: torch.Tensor, scale: torch.Tensor,
                  wire: torch.dtype) -> None:
        """x's ghost columns from their owners, in place, through the
        collective transport, the payload in the wire dtype: the gradient
        exchange's is the halo dtype, the var exchange's f32."""
        self._unpack(x, self.transport.exchange(self._pack(x, scale, wire)))

    def forward(self, var_T: torch.Tensor, tables: dict,
                schedule: str = "bulk") -> torch.Tensor:
        """One step → (P, rows, ndev): gg gradients (row d*NV+v) or flux
        residuals (row v), ghost columns filled from their owners (except
        under nocomm)."""
        if schedule in ("bulk", "nocomm"):
            g = self._sweep("bulk", var_T, tables)
            if schedule == "bulk" and self.moves:
                self._exchange(g, self.send_mask, self.halo_t)
            return g
        # the boundary sums.  K1's zero-filled form writes the zeros of the
        # blocks the class leaves out itself, spread over its launch, so no
        # fill runs before it.  K2's hand each gap to the CTAs of the entry
        # before it (sweep_common.cuh::clear_gaps), and a boundary plan
        # lists few entries (at one shard one, of one to four CTAs): there
        # the sweep accumulates onto a zero fill (PERF.md section 6), which
        # the boundary's span counts with the sweep
        init = None
        if self.kernel == "gather":
            with spans.span(SWEEP_SPANS["boundary"], self.device):
                init = torch.zeros((self.nlocal, self.rows, self.ndev),
                                   dtype=self.grad_t, device=self.device)
        gb = self._sweep("boundary", var_T, tables, init=init)
        if schedule == "overlap" and self.has_comm and self.kernel_phases:
            return self._overlap(var_T, tables, gb)
        # early, or overlap with nothing for the fused kernel to carry
        # (nothing moves, or every phase is a collective one): start the
        # exchange, sweep the interior onto the boundary sums, finish it
        pending = (self.transport.start(self._pack(gb, self.pack_scale,
                                                   self.halo_t))
                   if self.moves else None)
        g = self._sweep("interior", var_T, tables, init=gb)
        if pending is not None:
            self._unpack(g, self.transport.finish(pending))
        return g

    def _overlap(self, var_T: torch.Tensor, tables: dict,
                 gb: torch.Tensor) -> torch.Tensor:
        """The fused step: the interior sweep onto the boundary sums gb
        with the push of `kernel_phases` inside the launch; the collective
        phases, if the routing left any, are posted before the kernel and
        unpacked after it (gradients_pallas.py:898-1010)."""
        fused = sweep_blocks_overlap_gather if self.kernel == "gather" \
            else sweep_blocks_overlap
        bufs = self._pack(gb, self.pack_scale, self.halo_t)
        pending = None
        if self.routed:
            with spans.span("pack", self.device):   # the carriers' split
                coll = bufs.index_select(1, self.coll_index)
                bufs = bufs.index_select(1, self.kernel_index)
            pending = self.coll.start(coll)
        if self.peer is not None:       # it holds its own push map
            push = (None, None, self.op)
            how = {"peer": self.peer}
        else:
            push, how = (*self.kernel_map, self.op), {}
        with spans.span(SWEEP_SPANS["interior"], self.device):
            g, recv = fused(var_T, *self._operands("interior", tables), gb,
                            bufs, *push, **how, **self._gather_kw("interior"))
        if not self.routed:
            self._unpack(g, recv)
            return g
        self._unpack(g, recv, self.kernel_phases)
        self._unpack(g, self.coll.finish(pending), self.coll_phases)
        return g

    def iter_args(self, state: dict) -> tuple:
        return state["var_T"], state["tables"]

    def step(self, state: dict, schedule: str = "bulk") -> torch.Tensor:
        self.check_schedule(schedule, state["tables"])
        return self(state["var_T"], state["tables"], schedule)

    def chain_body(self, schedule: str, coupling: float = COUPLING):
        """One step of the chained loop: body(v, tables, out=None) → v +
        coupling · g[:, :NV] (the reference's chained update, with its
        types: the product in the grad dtype, the sum f32; one kernel,
        `ops.update.chain_update`, as XLA fuses it), a new tensor or,
        given, `out` (the sum written there); v is not written."""
        def body(v, tables, out=None):
            g = self(v, tables, schedule)
            with spans.span("update", self.device):
                return chain_update(v, g, coupling, out)

        return body

    def solver_body(self, schedule: str, sweeps_per_step: int,
                    coupling: float = COUPLING):
        """One solver-mode step (`GreenGaussPallas._solver_iterate_fn`'s
        body, gradients_pallas.py:1146-1170): body(v, out=None) rebuilds
        ONLY the tables the schedule reads from v, runs sweeps_per_step
        stages of sweep (with its gradient exchange) + update against them,
        then the var exchange (in place on the step's own new tensor, or on
        `out`, which the last update writes)."""
        needed = SCHEDULE_CLASSES[schedule]

        def body(v, out=None):
            tb = self._build_tables(v, needed)
            for i in range(sweeps_per_step):
                g = self(v, tb, schedule)
                with spans.span("update", self.device):
                    v = chain_update(v, g, coupling,
                                     out if i == sweeps_per_step - 1
                                     else None)
            return self._var_exchange(v)

        return body

    def iterate_fn(self, schedule: str, n: int, solver_mode: bool = False,
                   sweeps_per_step: int = 1, *, graph: bool | None = None,
                   coupling: float = COUPLING):
        """Chained n-step runner over iter_args; returns the final var_T, a
        new tensor (the caller's is not written).

        Without solver_mode each step's gradients feed the next step's
        state (`chain_body`) over the state's fixed tables, so no step can
        be skipped.  solver_mode=True runs the per-time-step dataflow of a
        real solver built on the proxy (`solver_body`): each step rebuilds
        ONLY the tables the schedule reads from the carried var_T, runs
        sweeps_per_step stages of sweep + update, then one var exchange; the
        state's own tables are not read.  No step syncs the host.

        graph: None follows `compiled.dispatch` (on a CUDA device, where
        every exchange of the body runs in a kernel or on the device, the
        step is captured as CUDA graphs once and replayed, n steps, bit for
        bit the eager loop: at one rank every body, at several ranks
        through `peer` the static overlap chain with no routed phase;
        elsewhere eager); False runs eager; True raises `CheckError` where
        the rule says eager.  coupling: the update's factor, the
        reference's 1e-30 by default (which leaves an f32 state as it was);
        a check that must see the gradients in the state takes a larger
        one."""
        check(sweeps_per_step >= 1, "sweeps_per_step must be >= 1, got %d",
              sweeps_per_step)
        check(sweeps_per_step == 1 or solver_mode,
              "sweeps_per_step only applies to solver_mode (static "
              "iteration never rebuilds tables)")
        key = (schedule, solver_mode, sweeps_per_step, coupling)
        if solver_mode:
            check(schedule in SCHEDULE_CLASSES, "unknown schedule %r (the "
                  "port runs %s)", schedule, "/".join(SCHEDULES))
            run_solver = compiled.runner(
                self, self.solver_body(schedule, sweeps_per_step, coupling),
                n, key, graph=graph, schedule=schedule, solver_mode=True)
            # the state's tables are not read: the body rebuilds its own
            return lambda var_T, tables: run_solver(var_T)
        return compiled.runner(
            self, self.chain_body(schedule, coupling), n, key, graph=graph,
            schedule=schedule,
            precheck=lambda var_T, tables: self.check_schedule(schedule,
                                                               tables))

    # ------------------------------------------------------------ gather

    def gather_global(self, grad: torch.Tensor) -> np.ndarray:
        """(P, rows, ndev) device result → global host array, the
        reference's convention: gg (N, nvar*3), column v*3+d; flux
        (N, nvar).  bf16 results are widened to f32 (numpy has no bf16),
        as the reference widens them."""
        grad = grad.detach()
        if grad.dtype == BF16:
            grad = grad.float()
        arr = gather_shards(grad, self.group).numpy()
        N = sum(p.nowned for p in self.parts)
        if self.op == "flux":
            out = np.zeros((N, self.nvar), dtype=arr.dtype)
            for i, p in enumerate(self.parts):
                out[p.global_ids[: p.nowned]] = \
                    arr[i, : self.nvar, : p.nowned].T
            return out
        out = np.zeros((N, self.nvar * 3), dtype=arr.dtype)
        for i, p in enumerate(self.parts):
            gids = p.global_ids[: p.nowned]
            for v in range(self.nvar):
                for d in range(3):
                    out[gids, v * 3 + d] = arr[i, d * NV + v, : p.nowned]
        return out


# the pack's counters (models/compiled.py: the port's counters): wire bytes
# written, padded to s_max over every phase, and those of the send columns
# send_mask marks live
GreenGaussTorch._pack.halo_bytes = 0
GreenGaussTorch._pack.halo_live_bytes = 0


def halo_counters() -> dict:
    """{name: (function, attribute)} of the pack's counters."""
    return {k: (GreenGaussTorch._pack, k)
            for k in ("halo_bytes", "halo_live_bytes")}


class PSDFluxModel(GreenGaussTorch):
    """The secondary model family: the PSD upwind flux (ops/flux.py's
    `compute_psd_flux`, NV output rows) on the same plans, schedules and
    exchange.  Counterpart of
    `cfd_proxy_tpu/models/gradients_pallas.py::PSDFluxModel`."""

    def __init__(self, parts, nvar, **kw):
        super().__init__(parts, nvar, op="flux", **kw)
