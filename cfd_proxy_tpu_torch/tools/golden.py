"""Golden-file dump and check, on the port.

Counterpart of `cfd_proxy_tpu/tools/golden.py`, with its options, messages
and file format: `dump` writes the f64 golden gradients (or flux residuals)
of a generated mesh to a netCDF file (the port's own `mesh/netcdf3.py`);
`check` recomputes them, with the golden itself (bitwise), the kernel
model (`--backend pallas`, `GreenGaussTorch` / `PSDFluxModel`, f32: within
1e-5 relative) or the ELL model in f64 (`--backend xla`: within 1e-12), and
compares against the file.  A check whose generation options differ from
the ones the file stores reports the drift and exits 1.

    python -m cfd_proxy_tpu_torch.tools.golden dump  --nx 12 --out golden.nc
    python -m cfd_proxy_tpu_torch.tools.golden check --nx 12 \\
        --ref golden.nc --backend pallas --parts 4 --schedule overlap

The models run on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh import netcdf3
from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.models.gradients_ell import GreenGaussModel
from cfd_proxy_tpu_torch.solver import golden


def _mesh_and_state(args):
    ny = args.ny or args.nx
    nz = args.nz or args.nx
    mesh = generate_mesh(args.nx, ny, nz, jitter=args.jitter,
                         diag_frac=args.diag_frac, seed=args.seed)
    var = make_state(mesh.npoint, args.nvar, seed=args.seed + 1)
    return mesh, var


def cmd_dump(args) -> int:
    mesh, var = _mesh_and_state(args)
    grad = golden(args.model, mesh, var)
    ds = netcdf3.Dataset()
    ds.attrs = {
        "nx": args.nx, "ny": args.ny or args.nx, "nz": args.nz or args.nx,
        "nvar": args.nvar, "seed": args.seed, "jitter": args.jitter,
        "diag_frac": args.diag_frac, "model": args.model,
    }
    ds.add("gradients", ("points", "cols"), grad)
    netcdf3.write(args.out, ds)
    print(f"wrote {args.out}: {args.model} field {grad.shape} (f64 golden)")
    return 0


def cmd_check(args) -> int:
    mesh, var = _mesh_and_state(args)
    ds = netcdf3.read(args.ref)
    ref_model = ds.attrs.get("model", "gg")   # pre-flux dumps are gg
    if ref_model != args.model:
        raise SystemExit(
            f"{args.ref} was dumped with --model {ref_model}; rerun check "
            f"with --model {ref_model} (got {args.model})")
    # a check run with other generation options compares another field by
    # construction: reported as such (exit 1), not as a numerical fault
    drift = {}
    for key in ("nx", "ny", "nz", "nvar", "seed", "jitter", "diag_frac"):
        stored = ds.attrs.get(key)
        ours = {"ny": args.ny or args.nx, "nz": args.nz or args.nx}.get(
            key, getattr(args, key))
        if stored is not None and stored != ours:
            drift[key] = (stored, ours)
    if drift:
        print(f"config MISMATCH vs {args.ref}: " + ", ".join(
            f"{k} dumped={a} check={b}" for k, (a, b) in drift.items())
            + " — the fields differ by construction")
        return 1
    ref = ds["gradients"]
    if args.backend == "golden":
        got = golden(args.model, mesh, var)
        exact = bool((got == ref).all())
        print(f"golden vs {args.ref}: bitwise {'MATCH' if exact else 'MISMATCH'}")
        return 0 if exact else 1
    parts = partition_mesh(mesh, args.parts, ghost_layers=args.ghost_layers)
    if args.backend == "pallas":
        model = GreenGaussTorch(parts, args.nvar, op=args.model,
                                device=args.device)
    elif args.model == "flux":
        raise SystemExit("--model flux requires --backend pallas")
    else:
        model = GreenGaussModel(parts, args.nvar, dtype=torch.float64,
                                device=args.device)
    state = model.distribute_state(var)
    got = model.gather_global(model.step(state, args.schedule))
    denom = max(1.0, float(np.abs(ref).max()))
    rel = float(np.abs(got - ref).max()) / denom
    # f32: rounding over ~K reordered f32 accumulations, ≈ K·2^-24 relative
    bound = 1e-12 if got.dtype == np.float64 else 1e-5
    ok = rel < bound
    print(f"{args.backend}/{args.schedule} vs {args.ref}: rel max err "
          f"{rel:.3e} (bound {bound:.0e}) -> {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.golden")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("dump", "check"):
        p = sub.add_parser(name)
        p.add_argument("--nx", type=int, default=12)
        p.add_argument("--ny", type=int, default=0)
        p.add_argument("--nz", type=int, default=0)
        p.add_argument("--nvar", type=int, default=7)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--jitter", type=float, default=0.05)
        p.add_argument("--diag-frac", type=float, default=0.2)
        p.add_argument("--model", default="gg", choices=["gg", "flux"])
        if name == "dump":
            p.add_argument("--out", required=True)
        else:
            p.add_argument("--ref", required=True)
            p.add_argument("--backend", default="golden",
                           choices=["golden", "pallas", "xla"])
            p.add_argument("--schedule", default="bulk")
            p.add_argument("--parts", type=int, default=1)
            p.add_argument("--ghost-layers", type=int, default=1)
            p.add_argument("--device", default="cuda",
                           choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return cmd_dump(args) if args.cmd == "dump" else cmd_check(args)


if __name__ == "__main__":
    raise SystemExit(main())
