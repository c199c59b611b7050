"""The ELL Green-Gauss sweep in plain PyTorch (the `--backend xla` model).

Counterpart of `cfd_proxy_tpu/ops/sweep_jax.py`: the reference's face loop
(`compute_gradients_gg`) over the padded incidence tables of `ops/prep.py`,
as dense gathers and reductions, no scatter in the sweep itself:

- `face_contrib`: C[f] = 0.5*(var[p0]+var[p1]) ⊗ n[f], two row gathers;
- `ell_reduce`: each point sums its incident faces' contributions over the
  slots of its ELL row.  `exact=True` adds the slots one by one in slot
  (incidence id) order, so an f64 run equals the golden loop on the plan's
  faces bit for bit; otherwise gather then one reduction (`torch.einsum`);
- `sweep_bulk`, `sweep_boundary`, `sweep_interior`: bulk equals boundary
  then interior (init = the boundary sums) bit for bit under `exact`, the
  property the schedules rely on;
- `sweep_rows_segment`: the sorted incidence rows summed by segment;
- `scale_owned`: 1/volume at owned points.

Every function takes one shard's arrays, (npoint_pad, nvar) state and the
plan's tables, or the same with leading shard axes, (P, npoint_pad, nvar)
and (P, ...) tables: the model holds its P shards stacked.  No op here is a
hand-written kernel: the reference's are XLA ops, so eager torch ops are the
port.  The order of operations is the reference's and nothing is fused or
compiled, which is what keeps the exact path bitwise.

f32 note: the non-exact `ell_reduce` is a batched matrix product, which on
a CUDA card runs in TF32 if the process enables it (`allow_tf32`,
`set_float32_matmul_precision`) and then misses the 1e-5 golden gate by
two orders; the port never enables it and the model refuses to run an f32
sweep on a card where it is on (`check_no_tf32`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from cfd_proxy_tpu_torch.ops.prep import SweepPlan
from cfd_proxy_tpu_torch.utils.errors import check


INDEX_FIELDS = ("faces_b", "faces_i", "b_points", "binc_face", "iinc_face",
                "finc_face", "row_face", "row_point")


@dataclass(frozen=True)
class DeviceSweep:
    """A SweepPlan's tables as tensors in the compute dtype (index tables
    int64), for one shard or with a leading shard axis (`stack`)."""

    faces_b: torch.Tensor     # (B_pad, 2) index
    normals_b: torch.Tensor   # (B_pad, 3) dtype
    faces_i: torch.Tensor     # (I_pad, 2) index
    normals_i: torch.Tensor   # (I_pad, 3) dtype
    b_points: torch.Tensor    # (nbp_pad,) index
    binc_face: torch.Tensor   # (nbp_pad, maxdeg_b) index (into boundary slice)
    binc_sign: torch.Tensor   # (nbp_pad, maxdeg_b) dtype
    iinc_face: torch.Tensor   # (npoint_pad, maxdeg_i) index (interior slice)
    iinc_sign: torch.Tensor   # (npoint_pad, maxdeg_i) dtype
    finc_face: torch.Tensor   # (npoint_pad, maxdeg_f) index (into [B|I])
    finc_sign: torch.Tensor   # (npoint_pad, maxdeg_f) dtype
    row_face: torch.Tensor    # (nrow_pad,) index (into [B|I])
    row_sign: torch.Tensor    # (nrow_pad,) dtype
    row_point: torch.Tensor   # (nrow_pad,) index, sorted
    owned_mask: torch.Tensor  # (npoint_pad, 1) dtype, 1 at owned points
    inv_volume: torch.Tensor  # (npoint_pad, 1) dtype, 1/volume at owned, 1 else

    @staticmethod
    def stack(sweeps: list["DeviceSweep"]) -> "DeviceSweep":
        """The shards' sweeps (equal shapes: one `SweepPads`) along a
        leading shard axis."""
        return DeviceSweep(**{f.name: torch.stack([getattr(s, f.name)
                                                   for s in sweeps])
                              for f in fields(DeviceSweep)})

    @staticmethod
    def from_arrays(arrays: dict, dtype: torch.dtype,
                    device: str | torch.device) -> "DeviceSweep":
        """From host arrays by field name (another model's tables,
        convert.sweeps_from_jax): index tables as int64, values cast to
        dtype."""
        return DeviceSweep(**{
            f.name: torch.as_tensor(np.array(arrays[f.name])).to(
                device=device, dtype=torch.int64 if f.name in INDEX_FIELDS
                else dtype)
            for f in fields(DeviceSweep)})


def device_sweep(plan: SweepPlan, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cpu") -> DeviceSweep:
    """A SweepPlan's tables on `device` in the compute dtype (counterpart
    of `sweep_jax.device_sweep`; inv_volume is 1 until `set_volume`)."""
    bp = plan.nface_b_pad
    owned = np.zeros((plan.npoint_pad, 1), dtype=np.float64)
    owned[: plan.nowned] = 1.0

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def val(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(
            dtype)

    return DeviceSweep(
        faces_b=idx(plan.faces[:bp]), normals_b=val(plan.normals[:bp]),
        faces_i=idx(plan.faces[bp:]), normals_i=val(plan.normals[bp:]),
        b_points=idx(plan.ell_boundary.points),
        binc_face=idx(plan.ell_boundary.inc_face),
        binc_sign=val(plan.ell_boundary.inc_sign),
        iinc_face=idx(plan.ell_interior.inc_face),
        iinc_sign=val(plan.ell_interior.inc_sign),
        finc_face=idx(plan.ell_full.inc_face),
        finc_sign=val(plan.ell_full.inc_sign),
        row_face=idx(plan.row_face), row_sign=val(plan.row_sign),
        row_point=idx(plan.row_point),
        owned_mask=val(owned),
        inv_volume=val(np.ones((plan.npoint_pad, 1))),
    )


def set_volume(ds: DeviceSweep, volume: np.ndarray, nowned: int
               ) -> DeviceSweep:
    """inv_volume from a host volume array (owned points only), computed in
    f64 on the host and cast, as the reference does."""
    invvol = np.ones((ds.inv_volume.shape[-2], 1), dtype=np.float64)
    invvol[:nowned, 0] = 1.0 / volume[:nowned]
    return replace(ds, inv_volume=torch.as_tensor(invvol).to(
        device=ds.inv_volume.device, dtype=ds.inv_volume.dtype))


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :]: rows of x (..., N, C) at idx (..., M) → (..., M, C),
    shard by shard over the leading axes.  Every index must lie in [0, N):
    the plans pad with valid rows (inert through sign 0 or zero normals)."""
    if x.dim() == 2:
        return x.index_select(0, idx)
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(*idx.shape,
                                                        x.shape[-1]))


def face_contrib(var: torch.Tensor, faces: torch.Tensor,
                 normals: torch.Tensor) -> torch.Tensor:
    """C[f, v*3+d] = 0.5*(var[p0,v]+var[p1,v]) * n[f,d]; (..., F, nvar*3)."""
    nvar = var.shape[-1]
    avg = 0.5 * (take_rows(var, faces[..., 0]) + take_rows(var, faces[..., 1]))
    c = avg.unsqueeze(-1) * normals.unsqueeze(-2)
    return c.reshape(*faces.shape[:-1], nvar * 3)


def ell_reduce(contrib: torch.Tensor, inc_face: torch.Tensor,
               inc_sign: torch.Tensor, init: torch.Tensor, *,
               exact: bool) -> torch.Tensor:
    """init + Σ_k sign[:, k] · contrib[inc_face[:, k]] per row: contrib
    (..., F, nv3), inc_face / inc_sign (..., R, K), init (..., R, nv3).
    exact: one add per slot in slot order (the golden's order; the product
    by ±1 or 0 is exact); else gather every slot, then one reduction."""
    if exact:
        g = init
        for k in range(inc_face.shape[-1]):
            g = g + inc_sign[..., k:k + 1] * take_rows(contrib,
                                                       inc_face[..., k])
        return g
    gathered = take_rows(contrib, inc_face.flatten(-2))
    gathered = gathered.reshape(*inc_face.shape, contrib.shape[-1])
    return init + torch.einsum("...rk,...rkc->...rc", inc_sign, gathered)


def reduce_bytes(ds: DeviceSweep, nv3: int, dtype: torch.dtype) -> int:
    """Bytes the non-exact bulk `ell_reduce` materialises: its gathered
    (..., npoint_pad, maxdeg_full, nv3) slots in `dtype`."""
    return int(ds.finc_face.numel()) * nv3 * torch.finfo(dtype).bits // 8


def sweep_bulk(var: torch.Tensor, ds: DeviceSweep, *, exact: bool = False
               ) -> torch.Tensor:
    """One sweep over all faces → raw grad (..., npoint_pad, nvar*3)."""
    c_b = face_contrib(var, ds.faces_b, ds.normals_b)
    c_i = face_contrib(var, ds.faces_i, ds.normals_i)
    contrib = torch.cat([c_b, c_i], dim=-2)
    init = contrib.new_zeros((*ds.finc_face.shape[:-1], contrib.shape[-1]))
    return ell_reduce(contrib, ds.finc_face, ds.finc_sign, init, exact=exact)


def _scatter_add_rows(x: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :] += rows, shard by shard, in place."""
    if x.dim() == 2:
        return x.index_add_(0, idx, rows)
    return x.scatter_add_(-2, idx.unsqueeze(-1).expand_as(rows), rows)


def sweep_boundary(var: torch.Tensor, ds: DeviceSweep, *,
                   exact: bool = False) -> torch.Tensor:
    """Boundary-face sweep → raw grad (..., npoint_pad, nvar*3), nonzero only
    at boundary-adjacent points, whose sums (send points' included) are
    final after it.

    The compact rows are added into zeros at b_points: the real b_points
    are unique, and the padding repeats the last row with all-zero sums.  On
    a CUDA card the add is atomic, in no fixed order; each real point still
    receives one value and the pad row adds zeros, so the result is exact."""
    contrib = face_contrib(var, ds.faces_b, ds.normals_b)
    init = contrib.new_zeros((*ds.binc_face.shape[:-1], contrib.shape[-1]))
    rows = ell_reduce(contrib, ds.binc_face, ds.binc_sign, init, exact=exact)
    grad = contrib.new_zeros((*ds.finc_face.shape[:-1], contrib.shape[-1]))
    return _scatter_add_rows(grad, ds.b_points, rows)


def sweep_interior(var: torch.Tensor, ds: DeviceSweep, init: torch.Tensor,
                   *, exact: bool = False) -> torch.Tensor:
    """Interior-face sweep added onto `init` (the boundary sums): each point
    then sums its slots in sweep_bulk's order, so the two agree bit for bit
    in f64 under `exact`."""
    contrib = face_contrib(var, ds.faces_i, ds.normals_i)
    return ell_reduce(contrib, ds.iinc_face, ds.iinc_sign, init, exact=exact)


def sweep_rows_segment(var: torch.Tensor, ds: DeviceSweep) -> torch.Tensor:
    """Sorted-segment sum over the incidence rows (not bit-exact: on a CUDA
    card the segment sum is an atomic add in no fixed order)."""
    c_b = face_contrib(var, ds.faces_b, ds.normals_b)
    c_i = face_contrib(var, ds.faces_i, ds.normals_i)
    contrib = torch.cat([c_b, c_i], dim=-2)
    data = ds.row_sign.unsqueeze(-1) * take_rows(contrib, ds.row_face)
    out = contrib.new_zeros((*ds.finc_face.shape[:-1], contrib.shape[-1]))
    return _scatter_add_rows(out, ds.row_point, data)


def scale_owned(grad: torch.Tensor, ds: DeviceSweep) -> torch.Tensor:
    """Times 1/volume at owned points (identity at ghosts and padding)."""
    return grad * torch.where(ds.owned_mask > 0, ds.inv_volume,
                              torch.ones_like(ds.inv_volume))


def check_no_tf32(dtype: torch.dtype, device: torch.device) -> None:
    """An f32 sweep on a CUDA card needs full-precision matrix products
    (module docstring)."""
    check(dtype != torch.float32 or device.type != "cuda"
          or (not torch.backends.cuda.matmul.allow_tf32
              and torch.get_float32_matmul_precision() == "highest"),
          "TF32 matrix products are enabled in this process (allow_tf32 / "
          "set_float32_matmul_precision): the f32 ELL sweep would miss the "
          "1e-5 golden gate")
