"""GreenGaussTorch — the port's Green-Gauss model on the block-sweep kernels.

Counterpart of the parts of `cfd_proxy_tpu/models/gradients_pallas.py::
GreenGaussPallas` that the one-shard `bulk` schedule runs:

- `__init__`: block-size rule, RCB locality relabel (+ in-block degree sort
  for the compact layout), halo topology, transposed device layout, the bulk
  BlockPlan with faces ordered boundary-first and the compact prefix
  widths — the reference's host construction, step for
  step, so both packages hold identical plan data;
- `distribute_state`: host state → (NV, ndev) `var_T` + the packed source
  table (`pack_srcs` kernel);
- `step(state, "bulk")`: one sweep (`sweep_blocks` kernel).  At one shard
  the layout has a single inert phase and the bulk exchange moves nothing;
- `iterate_fn("bulk", n)`: the chained n-step loop the timing uses;
- `gather_global`: device rows d*NV+v → global (N, nvar*3) column v*3+d.

Every option the slice does not run raises `CheckError` naming the ROADMAP
item that brings it.
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
    pack_srcs,
    slot_table,
    sweep_blocks,
)
from cfd_proxy_tpu_torch.ops.plan import (
    NV,
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
    build_halo_topology,
    entry_phases,
)

# AUTO block-size rule (bp=None), kept from the reference so that both
# packages build the same layout; it is to be re-decided on the GPU.
BP_AUTO_SMALL = 262144
BP_SMALL = 1024
# the schedules the reference runs, and the ROADMAP item that brings each
# one the port does not run yet
SCHEDULE_ITEMS = {"early": "queue 1 item 5", "overlap": "queue 1 item 6",
                  "nocomm": "queue 1 item 4"}
# the plan arrays `from_arrays` takes (see convert.plans_from_jax)
PLAN_KEYS = ("block_ids", "src_cols", "slot_w", "scale", "wks", "locmap",
             "ndev", "bp")


def host_plan_arrays(parts: list[MeshPartition], *, bp: int,
                     kcompact: bool) -> dict[str, np.ndarray]:
    """The bulk-class plan of one RELABELED shard as host arrays (PLAN_KEYS),
    built exactly as `GreenGaussPallas.__init__` builds it
    (gradients_pallas.py:337-439, bulk class)."""
    check(len(parts) == 1, "the port runs one shard; --parts > 1 comes with "
          "ROADMAP queue 1 item 4 (halo exchange at P>1)")
    npoint_pad = max(p.npoint for p in parts) + 1
    topo = build_halo_topology(parts, npoint_pad)
    lay = build_tlayout(parts, topo, bp=bp)
    p = parts[0]
    fd, nd = device_faces(p, lay)
    inv = device_inv_scale(p, lay)
    # bulk plan over faces reordered [boundary | interior], so each point
    # sums its boundary slots first — the order the reference's composed
    # early schedule adds them in
    is_send = np.zeros(lay.ndev, bool)
    is_send[send_point_set(p)] = True
    bsel = is_send[fd[:, 0]] | is_send[fd[:, 1]]
    order = np.concatenate([np.flatnonzero(bsel), np.flatnonzero(~bsel)])
    # all_blocks: every block is listed, the trailing trash block included,
    # so the reference's uniform-dims and block-list padding (which only
    # P > 1 needs) are the identity here
    plan = build_block_plan(fd[order], nd[order], lay.ndev, inv, bp=bp,
                            all_blocks=True, dst_lt=p.nowned)
    if kcompact:
        wks = prefix_widths(plan.slot_w[None], bp)
    else:
        wks = (bp,) * plan.kslots          # every slot full width
    return {
        "block_ids": plan.block_ids.astype(np.int32),
        "src_cols": compact_src_cols(plan, wks),
        "slot_w": compact_slot_w(plan.slot_w, wks).astype(np.float32),
        "scale": plan.scale.astype(np.float32),
        "wks": np.asarray(wks, np.int64),
        "locmap": lay.locmap[0],
        "ndev": np.asarray(lay.ndev, np.int64),
        "bp": np.asarray(bp, np.int64),
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
    """One-shard Green-Gauss sweep on the port's CUDA kernels (bulk)."""

    def __init__(self, parts: list[MeshPartition], nvar: int, *,
                 bp: int | None = None, kcompact: bool | None = None,
                 device: str | torch.device = "cuda",
                 arrays: dict[str, np.ndarray] | None = None):
        """parts: the raw partitions (relabeled here, as the reference
        does), or — with `arrays` — partitions ALREADY relabeled by the
        model the arrays come from (see `from_arrays`)."""
        super().__init__()
        check(len(parts) == 1, "the port runs one shard; --parts > 1 comes "
              "with ROADMAP queue 1 item 4 (halo exchange at P>1)")
        check(1 <= nvar <= NV, "nvar %d outside [1, %d]", nvar, NV)
        self.nvar = int(nvar)
        self.device = torch.device(device)
        if arrays is None:
            self.kcompact = True if kcompact is None else bool(kcompact)
            self.bp = auto_bp(parts, bp)
            # pre-topology on the raw parts: phase ids for the comm-first
            # grouping of the relabel (inert at one shard, kept so the
            # relabel is the reference's)
            pre_topo = build_halo_topology(parts,
                                           max(p.npoint for p in parts) + 1)
            eph = entry_phases(parts, pre_topo)
            self.parts = [
                relabel_owned(p, rcb_owned_order(p, block=self.bp,
                                                 degree_sort=self.kcompact,
                                                 entry_phase=eph[d]))
                for d, p in enumerate(parts)
            ]
            arrays = host_plan_arrays(self.parts, bp=self.bp,
                                      kcompact=self.kcompact)
        else:
            missing = [k for k in PLAN_KEYS if k not in arrays]
            check(not missing, "plan arrays lack %s", missing)
            self.parts = list(parts)
            self.bp = int(arrays["bp"])
            self.kcompact = None          # decided by the arrays' source
        self.ndev = int(arrays["ndev"])
        self.wks = tuple(int(w) for w in arrays["wks"])
        self.locmap = np.asarray(arrays["locmap"], np.int64)
        check(self.locmap.shape == (self.parts[0].npoint,),
              "locmap covers %d points, the shard has %d",
              self.locmap.shape[0], self.parts[0].npoint)
        check(self.ndev % self.bp == 0, "ndev %d not a multiple of bp %d",
              self.ndev, self.bp)

        def buf(name, a, dtype):
            self.register_buffer(name, torch.tensor(
                np.ascontiguousarray(a, dtype), device=self.device))

        buf("block_ids", arrays["block_ids"], np.int32)
        buf("src_cols", arrays["src_cols"], np.int32)
        buf("slot_w", arrays["slot_w"], np.float32)
        buf("scale", arrays["scale"], np.float32)
        buf("slots", slot_table(self.wks), np.int32)
        check(self.src_cols.shape[1] == sum(self.wks) ==
              self.slot_w.shape[2], "compact length mismatch: src_cols %d, "
              "Σwks %d, slot_w %d", self.src_cols.shape[1], sum(self.wks),
              self.slot_w.shape[2])

    @classmethod
    def from_arrays(cls, parts: list[MeshPartition], nvar: int,
                    arrays: dict[str, np.ndarray], *,
                    device: str | torch.device = "cuda") -> "GreenGaussTorch":
        """Build from another model's plan arrays (convert.plans_from_jax)
        and its relabeled partitions — both packages then compute on
        identical plan data."""
        return cls(parts, nvar, device=device, arrays=arrays)

    # ------------------------------------------------------------- state

    def distribute_state(self, gvar: np.ndarray) -> dict:
        """Global (N, nvar) host state → {"var_T": (NV, ndev) f32,
        "tbl_bulk": (nb, NV, L) f32 packed sources}."""
        p = self.parts[0]
        check(gvar.shape[1] == self.nvar, "state has %d vars, model %d",
              gvar.shape[1], self.nvar)
        vals = gvar[p.global_ids].astype(np.float32)
        host = np.zeros((NV, self.ndev), np.float32)
        host[:self.nvar, self.locmap] = vals.T
        var_T = torch.from_numpy(host).to(self.device)
        return {"var_T": var_T, "tbl_bulk": pack_srcs(var_T, self.src_cols)}

    # ------------------------------------------------------------- steps

    @staticmethod
    def check_schedule(schedule: str) -> None:
        check(schedule == "bulk", "schedule %r: the port runs 'bulk' (%s)",
              schedule, f"ROADMAP {SCHEDULE_ITEMS[schedule]} brings it"
              if schedule in SCHEDULE_ITEMS else "unknown schedule")

    def forward(self, var_T: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
        """One bulk sweep → (3·NV, ndev) gradients, row d*NV+v."""
        return sweep_blocks(var_T, tbl, self.slot_w, self.scale,
                            self.block_ids, self.slots)

    def iter_args(self, state: dict) -> tuple:
        return state["var_T"], state["tbl_bulk"]

    def step(self, state: dict, schedule: str = "bulk") -> torch.Tensor:
        self.check_schedule(schedule)
        return self(*self.iter_args(state))

    def iterate_fn(self, schedule: str, n: int):
        """Chained n-step runner over iter_args: each step's gradients feed
        the next step's state (v + 1e-30·g[:NV], the reference's chained
        loop), so no step can be skipped; returns the final var_T."""
        self.check_schedule(schedule)

        def run(var_T, tbl):
            v = var_T
            for _ in range(n):
                g = self(v, tbl)
                v = v + 1e-30 * g[:NV]
            return v

        return run

    # ------------------------------------------------------------ gather

    def gather_global(self, grad: torch.Tensor) -> np.ndarray:
        """(3·NV, ndev) device gradients → global (N, nvar*3) host array,
        column v*3+d (the reference's convention)."""
        arr = grad.detach().cpu().numpy()
        p = self.parts[0]
        gids = p.global_ids[: p.nowned]
        out = np.zeros((p.nowned, self.nvar * 3), dtype=arr.dtype)
        for v in range(self.nvar):
            for d in range(3):
                out[gids, v * 3 + d] = arr[d * NV + v, : p.nowned]
        return out
