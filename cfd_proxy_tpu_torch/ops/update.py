"""The chained step's state update — kernel wrapper and plain version.

    out = v + coupling · g[:, :NV]

v (P, NV, ndev) f32, the state; g (P, rows, ndev), the step's output in
the grad dtype (f32 or bf16): 3·NV gradient rows or NV flux rows, of which
the update reads the first NV.  The types are the models' update's (the
reference's `v + 1e-30 * g[:, :NV, :]` in torch's rules): the product in
the grad dtype, computed in f32 and rounded to it, the sum in f32.

The reference writes the update inside `jax.jit` + `lax.fori_loop`
(`cfd_proxy_tpu/models/gradients_pallas.py:1102`, `:1166`), where XLA
fuses it into one pass; no `pallas_call` stands behind it.  `chain_update`
is that fusion by hand (csrc/update.cu): on CPU tensors it runs the plain
version beside it, `chain_update_ref`; on CUDA tensors it launches the
kernel on the current stream, never synchronises, and raises if the launch
fails.  The kernel equals the plain version bit for bit.

Launch counts: `chain_update.launches` (f32 g) and
`chain_update.g16_launches` (bf16 g), listed by `launch_counters()`.
"""

from __future__ import annotations

import torch

from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils.errors import check

F32, BF16 = torch.float32, torch.bfloat16


def chain_update_ref(v: torch.Tensor, g: torch.Tensor, coupling: float,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: two torch operations, the product in g's dtype and
    the sum in f32, into a new tensor or `out`."""
    return torch.add(v, coupling * g[:, :NV], out=out)


def chain_update(v: torch.Tensor, g: torch.Tensor, coupling: float,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """v + coupling · g[:, :NV] → a new (P, NV, ndev) f32 tensor or, given,
    `out` (the CUDA graph runner's static buffer); v is read, never
    written, unless it is `out`.  v and out contiguous f32, g (P, rows,
    ndev) contiguous f32 or bf16 with rows >= NV, all on one device.
    Kernel: csrc/update.cu."""
    check(isinstance(v, torch.Tensor) and isinstance(g, torch.Tensor),
          "chain_update takes tensors")
    check(v.dtype == F32 and v.dim() == 3 and v.shape[1] == NV
          and v.is_contiguous(), "chain_update: v must be a contiguous "
          "(P, %d, ndev) f32 tensor, got %s %s", NV, v.dtype, tuple(v.shape))
    P, _, ndev = v.shape
    check(g.dtype in (F32, BF16) and g.dim() == 3 and g.shape[0] == P
          and g.shape[1] >= NV and g.shape[2] == ndev
          and g.is_contiguous() and g.device == v.device,
          "chain_update: g must be a contiguous (%d, rows >= %d, %d) f32 or "
          "bf16 tensor on %s, got %s %s on %s", P, NV, ndev, v.device,
          g.dtype, tuple(g.shape), g.device)
    if out is not None:
        check(out.dtype == F32 and out.shape == v.shape
              and out.is_contiguous() and out.device == v.device,
              "chain_update: out must be a contiguous %s f32 tensor on %s, "
              "got %s %s on %s", tuple(v.shape), v.device, out.dtype,
              tuple(out.shape), out.device)
    check(v.device.type in ("cpu", "cuda"), "unsupported device %s (cpu runs "
          "the plain version, cuda the kernel)", v.device)
    if v.device.type == "cpu":
        return chain_update_ref(v, g, coupling, out)
    from cfd_proxy_tpu_torch.ops import _cuda

    dev = v.device
    if out is None:
        out = torch.empty_like(v)
    g16 = g.dtype == BF16
    with torch.cuda.device(dev):
        rc = _cuda.lib().cfd_chain_update(
            v.data_ptr(), g.data_ptr(), int(g16), g.shape[1], P, ndev,
            coupling, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check_launch(rc, "chain_update")
    attr = "g16_launches" if g16 else "launches"
    setattr(chain_update, attr, getattr(chain_update, attr) + 1)
    return out


chain_update.count_attrs = ("launches", "g16_launches")
for _a in chain_update.count_attrs:
    setattr(chain_update, _a, 0)


def launch_counters() -> dict:
    """{instance name: (wrapper, count attribute)}: "chain_update" (f32 g)
    and "chain_update_g16" (as `blocksweep.launch_counters`)."""
    return {"chain_update": (chain_update, "launches"),
            "chain_update_g16": (chain_update, "g16_launches")}
