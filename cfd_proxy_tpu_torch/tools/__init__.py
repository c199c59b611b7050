"""Tools of the port: the kernel bench (`kbench`), the model-level paired
A/B harness (`mbench`), the push bench (`icibench`) and the offline mesh
partitioner (`partition`), counterparts of the same-named modules of
`cfd_proxy_tpu/tools/`."""
