"""Block plans, golden and kernel wrappers of the port.

Host plans and the goldens (Green-Gauss, flux) are NumPy copies of their
counterparts in `cfd_proxy_tpu.ops` (the port imports nothing of the JAX
package); the kernels live in `blocksweep.py` and the chained update's in
`update.py`, built from `../csrc/` by `_cuda.py`; the ELL sweep of the xla
backend, plain torch, in `sweep_ell.py` on the plans of `prep.py`.
"""
