"""Offline mesh partitioner CLI, on the port's own mesh modules.

Counterpart of `cfd_proxy_tpu/tools/partition.py`, with its options and its
output names: generate → RCB partition → ghost closure → write one netCDF
partition file per shard, which the solver reads with `--mesh`.  It imports
nothing of the JAX package, whose partitioner would build its native
library into that package.

    python -m cfd_proxy_tpu_torch.tools.partition --nx 32 --parts 8 --out m
    # writes m.8p.0.nc ... m.8p.7.nc
"""

from __future__ import annotations

import argparse

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.mesh.reader import partition_path, write_partition


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.partition")
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--ny", type=int, default=0, help="default: nx")
    ap.add_argument("--nz", type=int, default=0, help="default: nx")
    ap.add_argument("--parts", type=int, required=True)
    ap.add_argument("--ghost-layers", type=int, default=1)
    ap.add_argument("--jitter", type=float, default=0.05)
    ap.add_argument("--diag-frac", type=float, default=0.2)
    ap.add_argument("--stretch", type=float, default=1.0,
                    help="geometric z-spacing growth (boundary-layer family)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="output file prefix")
    args = ap.parse_args(argv)

    ny = args.ny or args.nx
    nz = args.nz or args.nx
    mesh = generate_mesh(args.nx, ny, nz, jitter=args.jitter,
                         diag_frac=args.diag_frac, seed=args.seed,
                         stretch=args.stretch)
    parts = partition_mesh(mesh, args.parts, ghost_layers=args.ghost_layers)
    for p in parts:
        path = partition_path(args.out, p.part_id, args.parts)
        write_partition(path, p)
        print(f"wrote {path}: {p.nowned} owned + {p.nghost} ghost points, "
              f"{p.nface} faces, {len(p.comm)} comm entries")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
