"""Host-side exchange metadata: NumPy copies of `cfd_proxy_tpu.parallel`'s
topology and layout modules (the port imports nothing of the JAX
package)."""
