"""The exchange layer: NumPy copies of `cfd_proxy_tpu.parallel`'s topology
and layout modules (the port imports nothing of the JAX package), the
transports and the ranks' launcher, and the ELL model's halo exchange and
schedules (`halo.py`, `schedules.py`)."""
