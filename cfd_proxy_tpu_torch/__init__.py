"""cfd_proxy_tpu_torch — the PyTorch/CUDA port of `cfd_proxy_tpu`.

`cfd_proxy_tpu` (JAX/Pallas) stays the reference: every module here names
its counterpart there and is tested against it.  This package imports
`torch` and never `jax`; the jax-free host modules of the reference
(`cfd_proxy_tpu.mesh`, `cfd_proxy_tpu.utils`, `cfd_proxy_tpu.native`) are
reused as they are.

What runs today is the one-shard `bulk` slice of the benchmark: the packed
compact Green-Gauss sweep (`ops/blocksweep.py::sweep_blocks`) and its
source-table pack (`pack_srcs`), each a CUDA kernel for Hopper (`csrc/`)
beside a plain PyTorch version.

Layer map (mirrors `cfd_proxy_tpu`):
  parallel/  host copies of topology + transposed device layout
  ops/       host block plans, golden, kernel wrappers (+ `csrc/` sources)
  models/    GreenGaussTorch (nn.Module)
  convert.py carry a JAX model's plan arrays across
  solver.py  benchmark CLI (`python -m cfd_proxy_tpu_torch.solver`)
"""

__version__ = "0.1.0"
