"""The halo exchange's pack — kernel wrapper and plain version.

    buf[p, k, r, j] = x[p, r, idx[p, k, 0, j]] * scale[p, k, 0, j]

x (P, rows, ndev), the step's gradients (3·NV or NV rows, in the grad
dtype) or the state (NV rows, f32); idx (P, nph, 1, s_max) int32, the
layout's send columns; scale (P, nph, 1, s_max) f32, the send mask (bulk
gradients, already volume-scaled, and the state) or the mask times the
inverse volume (`pack_scale`: boundary sums are not scaled); buf (P, nph,
rows, s_max) in the wire dtype.  idx and scale carry the row axis as 1, so
they broadcast against the buffer.  The types are torch's for
`(x[shard, row, idx] * scale).to(wire)`: a bf16 x is widened by the f32
product, which is rounded to the wire dtype.

The reference packs with XLA slices and a take (`_pack_buf`,
`cfd_proxy_tpu/models/gradients_pallas.py:807`); no `pallas_call` stands
behind it.  `pack_halo` is that pass by hand (csrc/halo_pack.cu): on CPU
tensors it runs the plain version beside it, `pack_halo_ref`; on CUDA
tensors it launches the kernel on the current stream, never synchronises,
and raises if the launch fails.  The kernel equals the plain version bit
for bit on every lane.

Launch counts, one per (x dtype, wire dtype) form: `pack_halo.launches`
(f32 x and wire), `.x16_launches` (bf16 x), `.o16_launches` (bf16 wire),
`.x16_o16_launches` (both), listed by `launch_counters()`.
"""

from __future__ import annotations

import torch

from cfd_proxy_tpu_torch.utils.errors import check

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


def pack_halo_ref(x: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor,
                  wire: torch.dtype = F32) -> torch.Tensor:
    """Plain version: one advanced index over broadcast shard, row and
    column indices, a broadcast product, a cast."""
    P, rows = x.shape[:2]
    shard = torch.arange(P, device=x.device).view(P, 1, 1, 1)
    row = torch.arange(rows, device=x.device).view(1, 1, rows, 1)
    return (x[shard, row, idx] * scale).to(wire)


def pack_halo(x: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor,
              wire: torch.dtype = F32) -> torch.Tensor:
    """(P, rows, ndev) → a new (P, nph, rows, s_max) send buffer in the
    wire dtype.  x contiguous f32 or bf16; idx contiguous int32 and scale
    contiguous f32, both (P, nph, 1, s_max), s_max a multiple of 4 (the
    layout's is of 128), both 16-byte aligned (the kernel reads four lanes
    at once); every index in [0, ndev) (the model checks its layout once,
    at load); wire f32 or bf16; all on one device.  Kernel:
    csrc/halo_pack.cu."""
    check(isinstance(x, torch.Tensor) and isinstance(idx, torch.Tensor)
          and isinstance(scale, torch.Tensor), "pack_halo takes tensors")
    check(x.dtype in (F32, BF16) and x.dim() == 3 and x.is_contiguous(),
          "pack_halo: x must be a contiguous (P, rows, ndev) f32 or bf16 "
          "tensor, got %s %s", x.dtype, tuple(x.shape))
    P, rows, ndev = x.shape
    check(idx.dtype == I32 and idx.dim() == 4 and idx.shape[0] == P
          and idx.shape[2] == 1 and idx.is_contiguous()
          and idx.device == x.device,
          "pack_halo: idx must be a contiguous (%d, nph, 1, s_max) int32 "
          "tensor on %s, got %s %s on %s", P, x.device, idx.dtype,
          tuple(idx.shape), idx.device)
    check(scale.dtype == F32 and scale.shape == idx.shape
          and scale.is_contiguous() and scale.device == x.device,
          "pack_halo: scale must be a contiguous %s f32 tensor on %s, got "
          "%s %s on %s", tuple(idx.shape), x.device, scale.dtype,
          tuple(scale.shape), scale.device)
    check(idx.shape[3] % 4 == 0 and idx.data_ptr() % 16 == 0
          and scale.data_ptr() % 16 == 0, "pack_halo: idx and scale must "
          "hold whole quads of lanes (s_max %d a multiple of 4, both "
          "16-byte aligned)", idx.shape[3])
    check(wire in (F32, BF16), "pack_halo: the wire dtype must be float32 "
          "or bfloat16, got %s", wire)
    check(x.device.type in ("cpu", "cuda"), "unsupported device %s (cpu "
          "runs the plain version, cuda the kernel)", x.device)
    if x.device.type == "cpu":
        return pack_halo_ref(x, idx, scale, wire)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = x.device
    nph, s_max = idx.shape[1], idx.shape[3]
    buf = torch.empty((P, nph, rows, s_max), dtype=wire, device=dev)
    x16, o16 = x.dtype == BF16, wire == BF16
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_pack_halo(
            x.data_ptr(), int(x16), idx.data_ptr(), scale.data_ptr(), P,
            rows, ndev, nph, s_max, buf.data_ptr(), int(o16),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check_launch(rc, "pack_halo")
    attr = COUNT_ATTRS[x16, o16]
    setattr(pack_halo, attr, getattr(pack_halo, attr) + 1)
    return buf


# (bf16 x, bf16 wire) → the count attribute of that form
COUNT_ATTRS = {(False, False): "launches", (True, False): "x16_launches",
               (False, True): "o16_launches", (True, True): "x16_o16_launches"}
for _a in COUNT_ATTRS.values():
    setattr(pack_halo, _a, 0)


def launch_counters() -> dict:
    """{instance name: (wrapper, count attribute)}: "pack_halo",
    "pack_halo_x16", "pack_halo_o16" and "pack_halo_x16_o16" (as
    `blocksweep.launch_counters`)."""
    return {"pack_halo": (pack_halo, "launches"),
            "pack_halo_x16": (pack_halo, "x16_launches"),
            "pack_halo_o16": (pack_halo, "o16_launches"),
            "pack_halo_x16_o16": (pack_halo, "x16_o16_launches")}
