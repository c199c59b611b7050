"""The exchange schedules of the ELL model as step functions.

Counterpart of `cfd_proxy_tpu/parallel/schedules.py`.  Each function takes
the stacked state (P_local, npoint_pad, nvar), the shards' `DeviceSweep`
and `DeviceHalo`, and returns the gradients (P_local, npoint_pad, nvar*3)
with ghost rows filled from their owners.  Under `exact` all of them give
the same f64 bits (the same per-point order of sums):

  bulk   : full sweep → scale → exchange
  early  : boundary sweep → exchange posted (send rows are final: every
           face of a send point is a boundary face) → interior sweep onto
           the boundary sums → scale → exchange finished
  overlap: early's graph, as in the reference's XLA backend (the fused
           sweep + push kernel is the kernel model's, models/gradients.py)
  nocomm : bulk without the exchange, the compute-only floor

Senders scale at pack time (gather × 1/volume): the boundary sums are not
yet scaled when they leave.
"""

from __future__ import annotations

import torch

from cfd_proxy_tpu_torch.ops.sweep_ell import (DeviceSweep, scale_owned,
                                               sweep_boundary, sweep_bulk,
                                               sweep_interior)
from cfd_proxy_tpu_torch.parallel.halo import (DeviceHalo, exchange,
                                               exchange_finish,
                                               exchange_start)


def step_bulk(var: torch.Tensor, ds: DeviceSweep, halo: DeviceHalo, *,
              exact: bool = False) -> torch.Tensor:
    g = sweep_bulk(var, ds, exact=exact)
    g = scale_owned(g, ds)
    return exchange(g, halo)


def step_early(var: torch.Tensor, ds: DeviceSweep, halo: DeviceHalo, *,
               exact: bool = False) -> torch.Tensor:
    gb = sweep_boundary(var, ds, exact=exact)
    pending = exchange_start(gb, halo, scale=ds.inv_volume)
    g = sweep_interior(var, ds, gb, exact=exact)
    g = scale_owned(g, ds)
    return exchange_finish(g, pending, halo)


def step_overlap(var: torch.Tensor, ds: DeviceSweep, halo: DeviceHalo, *,
                 exact: bool = False) -> torch.Tensor:
    return step_early(var, ds, halo, exact=exact)


def step_nocomm(var: torch.Tensor, ds: DeviceSweep, halo: DeviceHalo, *,
                exact: bool = False) -> torch.Tensor:
    del halo                    # the floor: no exchange
    return scale_owned(sweep_bulk(var, ds, exact=exact), ds)


STEP_FNS = {
    "bulk": step_bulk,
    "early": step_early,
    "overlap": step_overlap,
    "nocomm": step_nocomm,
}
