"""cfd_proxy_tpu_torch — the PyTorch/CUDA port of `cfd_proxy_tpu`.

`cfd_proxy_tpu` (JAX/Pallas) stays the reference: every module here names
its counterpart there and is tested against it.  This package imports
`torch` and never `jax`; the jax-free host modules of the reference
(`cfd_proxy_tpu.mesh`, `cfd_proxy_tpu.utils`, `cfd_proxy_tpu.native`) are
reused as they are.

What runs today: the packed compact Green-Gauss sweep under the bulk,
early, overlap and nocomm schedules, at P shards held on one device with
the halo exchange between them (`models/gradients.py`).  Its kernels — the
sweep with and without `init` (`ops/blocksweep.py::sweep_blocks`), the
fused interior sweep + halo push (`sweep_blocks_overlap`) and the
source-table pack (`pack_srcs`) — are CUDA kernels for Hopper (`csrc/`),
each beside a plain PyTorch version.

Layer map (mirrors `cfd_proxy_tpu`):
  parallel/  host copies of topology + transposed device layout
  ops/       host block plans, golden, kernel wrappers (+ `csrc/` sources)
  models/    GreenGaussTorch (nn.Module)
  convert.py carry a JAX model's plan arrays across
  solver.py  benchmark CLI (`python -m cfd_proxy_tpu_torch.solver`)
"""

__version__ = "0.1.0"
