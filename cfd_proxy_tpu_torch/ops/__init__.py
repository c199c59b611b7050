"""Block plans, golden and kernel wrappers of the port.

Host plans and the golden are NumPy copies of the jax-free parts of
`cfd_proxy_tpu.ops` (whose `__init__` imports JAX); the kernels live in
`blocksweep.py`, built from `../csrc/` by `_cuda.py`.
"""
