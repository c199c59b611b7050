"""Host-side exchange metadata (NumPy copies of `cfd_proxy_tpu.parallel`'s
jax-free modules; that package's `__init__` imports JAX)."""
