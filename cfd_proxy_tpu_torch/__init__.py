"""cfd_proxy_tpu_torch — the PyTorch/CUDA port of `cfd_proxy_tpu`.

`cfd_proxy_tpu` (JAX/Pallas) stays the reference: every module here names
its counterpart there and is tested against it.  This package imports
`torch` and never `jax`, and nothing of `cfd_proxy_tpu`: it carries its own
copies of the reference's NumPy host layer (`mesh/`, `utils/`,
`native.py`, the plan, layout and golden modules), held equal to the
originals by tests/test_torch_host.py and tests/test_torch_plan.py.

What runs today: the block sweep for Green-Gauss gradients and for the PSD
upwind flux (`PSDFluxModel`), each in its packed (compact layout) and
gather formulations under the bulk, early, overlap and nocomm schedules, at
P shards held on one device with the halo exchange between them, and
solver mode — state update, var halo exchange, per-step table rebuild
(`models/gradients.py`); and the reference's XLA backend, the ELL sweep in
plain torch, f32 or f64 (`models/gradients_ell.py`).  Its kernels — the packed and the gather sweep
with and without `init` (`ops/blocksweep.py::sweep_blocks`,
`sweep_blocks_gather`), the fused interior sweep + halo push in both
formulations (`sweep_blocks_overlap`, `sweep_blocks_overlap_gather`), each
for both ops, and the source-table pack (`pack_srcs`) — are CUDA kernels
for Hopper (`csrc/`), each beside a plain PyTorch version.

Layer map (mirrors `cfd_proxy_tpu`):
  utils/     error checks, timing (copies)
  mesh/      mesh model, netCDF reader, generator, partitioner (copies)
  native.py  loader of the native host library (`native/*.cc`)
  parallel/  host copies of topology + transposed device layout
  ops/       host block plans, goldens, kernel wrappers (+ `csrc/` sources)
  models/    GreenGaussTorch, PSDFluxModel, GreenGaussModel (nn.Module)
  convert.py carry a JAX model's plan arrays across
  solver.py  benchmark CLI (`python -m cfd_proxy_tpu_torch.solver`)
  bench.py   headline benchmark, the root bench.py's counterpart
             (`python -m cfd_proxy_tpu_torch.bench`)
  tools/     kbench, mbench, icibench, partition, golden, fixture,
             solver_attrib, dryrun, scaling_model (+ scaling_inputs)
"""

__version__ = "0.1.0"
