"""Tools of the port: the kernel bench (`kbench`), the model-level paired
A/B harness (`mbench`), the push bench (`icibench`), the offline mesh
partitioner (`partition`), the golden-file dump and check (`golden`), the
pinned large-mesh fixture (`fixture`), the solver-mode attribution
(`solver_attrib`) and the multi-shard dry run (`dryrun`), counterparts of
the same-named modules of `cfd_proxy_tpu/tools/`."""
