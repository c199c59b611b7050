"""The benchmark of the PyTorch and CUDA port, `cfd_proxy_tpu_torch`
(`python3 -m cfdbench.run`; README.md beside this file).

Imports nothing of JAX or of the JAX package: the port is measured alone.
"""
