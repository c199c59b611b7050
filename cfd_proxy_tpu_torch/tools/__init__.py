"""Measurement tools of the port: the kernel bench (`kbench`) and the
model-level paired A/B harness (`mbench`), counterparts of
`cfd_proxy_tpu/tools/kbench.py` and `mbench.py`."""
