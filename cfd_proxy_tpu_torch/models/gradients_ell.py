"""GreenGaussModel — the ELL-backend model (`--backend xla`), f32 or f64.

Counterpart of `cfd_proxy_tpu/models/gradients.py::GreenGaussModel`: for a
partitioned mesh, the two-pass sweep plans with common pad sizes
(`ops/prep.py`), the tables on the device (`ops/sweep_ell.py`), the halo
phase schedule (`parallel/halo.py`) and a step for every schedule
(`parallel/schedules.py`).  One `step` is one timed iteration of the
benchmark: gradient sweep + gradient halo exchange.

The P shards sit stacked on one device, as `GreenGaussTorch` holds them,
or spread over the W ranks of a `torch.distributed` group (rank r holds
shards [r·P/W, (r+1)·P/W) on its own device, the buffers travel by
`Dist`).  No kernel of the port runs here: the reference's backend is
plain XLA, so this one is plain torch.  In f64 it runs on the card: the
H100 has native f64.  `exact=True` sums each point's slots in the golden's
order: in f64 the raw sums then equal `ops/golden.py` on each shard's plan
faces bit for bit, every schedule gives the same bits, and a run at W
ranks the bits of one process.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from cfd_proxy_tpu_torch.mesh.model import MeshPartition
from cfd_proxy_tpu_torch.mesh.partition import send_point_set
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.compiled import COUPLING
from cfd_proxy_tpu_torch.ops.prep import SweepPads, build_sweep_plan
from cfd_proxy_tpu_torch.ops.sweep_ell import (DeviceSweep, check_no_tf32,
                                               device_sweep, set_volume)
from cfd_proxy_tpu_torch.parallel.halo import (DeviceHalo, HostHalo,
                                               device_halo, exchange)
from cfd_proxy_tpu_torch.parallel.schedules import STEP_FNS
from cfd_proxy_tpu_torch.parallel.topology import build_halo_topology
from cfd_proxy_tpu_torch.parallel.transport import (gather_shards, group_size,
                                                    shard_range)
from cfd_proxy_tpu_torch.utils.errors import check

DTYPES = {"float32": torch.float32, "float64": torch.float64}
TRANSPORTS = ("loopback", "dist")
# the host arrays `arrays=` takes: "sweep" maps each DeviceSweep field to
# its (P, ...) stack; send_idx / recv_idx (P, nph, S); perms per phase
ARRAY_KEYS = ("npoint_pad", "sweep", "send_idx", "recv_idx", "perms")


class GreenGaussModel(nn.Module):
    """Green-Gauss gradients of P shards on the ELL sweep, with the halo
    exchange between them."""

    def __init__(self, parts: list[MeshPartition], nvar: int, *,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda",
                 slice_size: int | None = None, group=None,
                 transport: str | None = None, share_device: bool = False,
                 arrays: dict | None = None):
        """dtype: float32 or float64.  group: the `torch.distributed` group
        whose W ranks share the shards (None: this process holds them all);
        transport: "loopback" (W = 1, the default there) or "dist" (the
        default for W > 1).  slice_size: devices per node, for the phase
        coloring (`build_halo_topology`).  arrays: another model's tables
        and halo lists (ARRAY_KEYS, convert.sweeps_from_jax) in place of the
        plans built here from `parts`."""
        super().__init__()
        self.graphs = collections.OrderedDict()   # captured steps (compiled)
        check(len(parts) >= 1, "need at least one partition")
        check(dtype in DTYPES.values(), "dtype must be float32 or float64, "
              "got %s", dtype)
        self.parts = list(parts)
        self.nvar = int(nvar)
        self.dtype = dtype
        self.device = torch.device(device)
        check_no_tf32(dtype, self.device)
        self.group = group
        self.rank, self.world = group_size(group)
        self.lo, self.hi = shard_range(len(parts), self.rank, self.world)
        if transport is None:
            transport = "loopback" if self.world == 1 else "dist"
        check(transport in TRANSPORTS, "the ELL model's transport is "
              "loopback or dist (it has no fused kernel to push from), got "
              "%r", transport)
        check(transport != "loopback" or self.world == 1, "the loopback "
              "transport holds every shard in one process; %d ranks need "
              "dist", self.world)

        if arrays is None:
            # two-pass plan build → common shapes across shards
            raw = [build_sweep_plan(p.faces, p.normals, p.npoint, p.nowned,
                                    send_point_set(p)) for p in parts]
            pads = SweepPads.max_of(raw)
            self.plans = [build_sweep_plan(p.faces, p.normals, p.npoint,
                                           p.nowned, send_point_set(p),
                                           pads=pads) for p in parts]
            self.npoint_pad = pads.npoint_pad
            self.dsweep = DeviceSweep.stack([
                set_volume(device_sweep(self.plans[i], dtype=dtype,
                                        device=self.device),
                           parts[i].volume, parts[i].nowned)
                for i in range(self.lo, self.hi)])
            topo = build_halo_topology(parts, self.npoint_pad,
                                       slice_size=slice_size)
            halos = [device_halo(topo, i) for i in range(len(parts))]
        else:
            missing = [k for k in ARRAY_KEYS if k not in arrays]
            check(not missing, "sweep arrays lack %s", missing)
            self.plans = None
            self.npoint_pad = int(arrays["npoint_pad"])
            self.dsweep = DeviceSweep.from_arrays(
                {k: np.asarray(v)[self.lo:self.hi]
                 for k, v in arrays["sweep"].items()}, dtype, self.device)
            halos = [HostHalo(arrays["send_idx"][i], arrays["recv_idx"][i],
                              tuple(arrays["perms"]))
                     for i in range(len(parts))]
        self.transport_kind = transport
        self.perms = halos[0].perms
        self.halo = DeviceHalo.stack(
            halos, self.npoint_pad, self.lo, self.hi, self.device,
            group=group if transport == "dist" else None,
            share_device=share_device)
        self.transport_name = self.halo.transport.name

    # ------------------------------------------------------------- state

    def distribute_state(self, gvar: np.ndarray, *,
                         schedules=None) -> torch.Tensor:
        """Global (N, nvar) host state → (P_local, npoint_pad, nvar): owned
        rows from gvar, ghost rows by a var exchange.  `schedules` is the
        kernel model's table selection; every schedule here reads the same
        tables."""
        del schedules
        check(gvar.shape[1] == self.nvar, "state has %d vars, model %d",
              gvar.shape[1], self.nvar)
        vs = np.zeros((self.hi - self.lo, self.npoint_pad, self.nvar))
        for i in range(self.lo, self.hi):
            p = self.parts[i]
            vs[i - self.lo, : p.nowned] = gvar[p.global_ids[: p.nowned]]
        var = torch.from_numpy(vs).to(device=self.device, dtype=self.dtype)
        return exchange(var, self.halo)

    def exchange_var(self, var: torch.Tensor) -> torch.Tensor:
        """A copy of the stacked state with its ghost rows filled from their
        owners."""
        return exchange(var.clone(), self.halo)

    # -------------------------------------------------------------- step

    def forward(self, var: torch.Tensor, schedule: str = "overlap", *,
                exact: bool = False) -> torch.Tensor:
        """(P_local, npoint_pad, nvar) → gradients (P_local, npoint_pad,
        nvar*3), column v*3+d, ghost rows from their owners (but nocomm)."""
        check(schedule in STEP_FNS, "unknown schedule %r", schedule)
        return STEP_FNS[schedule](var, self.dsweep, self.halo, exact=exact)

    def step(self, var: torch.Tensor, schedule: str = "overlap", *,
             exact: bool = False) -> torch.Tensor:
        return self(var, schedule, exact=exact)

    def iter_args(self, state: torch.Tensor) -> tuple:
        return (state,)

    def iterate_fn(self, schedule: str, n: int, solver_mode: bool = False,
                   sweeps_per_step: int = 1, *, exact: bool = False,
                   graph: bool | None = None, coupling: float = COUPLING):
        """Chained n-step runner over iter_args: each step's gradients feed
        the next step's state (v + coupling·g[..., :nvar], the reference's
        loop at its 1e-30), so no step can be skipped; a new tensor comes
        back.  Solver mode is the kernel model's (the reference's too).
        graph, coupling: as in `GreenGaussTorch.iterate_fn`
        (models/compiled.py's rule: one CUDA graph of the step on a card at
        one rank; the ELL model's exchange at several ranks is `dist`)."""
        check(not solver_mode and sweeps_per_step == 1,
              "--solver-mode requires the pallas backend")
        check(schedule in STEP_FNS, "unknown schedule %r", schedule)
        nvar = self.nvar

        def body(v, out=None):
            return torch.add(v, coupling * self(v, schedule, exact=exact)
                             [..., :nvar], out=out)

        return compiled.runner(self, body, n, (schedule, exact, coupling),
                               graph=graph, schedule=schedule)

    # ------------------------------------------------------------ gather

    def gather_global(self, stacked: torch.Tensor) -> np.ndarray:
        """Stacked per-shard rows → global numbering on the host, (N, ncol),
        the same on every rank."""
        arr = gather_shards(stacked.detach(), self.group).numpy()
        N = sum(p.nowned for p in self.parts)
        out = np.zeros((N, arr.shape[-1]), dtype=arr.dtype)
        for i, p in enumerate(self.parts):
            out[p.global_ids[: p.nowned]] = arr[i, : p.nowned]
        return out

    def close(self) -> None:
        """Free the captured step graphs; nothing mapped to release (the
        solver closes every model)."""
        self.graphs.clear()
