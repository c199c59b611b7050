"""Tools of the port: the kernel bench (`kbench`), the model-level paired
A/B harness (`mbench`), the push bench (`icibench`), the offline mesh
partitioner (`partition`), the golden-file dump and check (`golden`), the
pinned large-mesh fixture (`fixture`), the solver-mode attribution
(`solver_attrib`), the multi-shard dry run (`dryrun`) and the analytic
multi-GPU model (`scaling_model`), counterparts of the same-named modules
of `cfd_proxy_tpu/tools/`; `scaling_inputs` measures that model's inputs
on a card."""
