"""Multi-shard dry run of the port: every model path at N shards, one step
each, with each leg's ran/skipped status in one JSON line.

Counterpart of `cfd_proxy_tpu/tools/dryrun.py` and the legs of
`__graft_entry__.dryrun_multichip`, with the N shards held in one process
on one device (the card unless `--device cpu`):

- `xla`: the ELL model, 2 ghost layers, the three schedules (each within
  1e-4 of bulk);
- `pallas`: the kernel model at bp 128 with the fused overlap kernel, at
  most PALLAS_CAP shards (beyond it the mesh is cut into PALLAS_CAP shards
  with one ghost layer); overlap within 1e-6 relative of early, bulk within
  1e-4;
- `reduced_precision`: the four bf16 options under overlap, within
  (0, 2e-2] relative of the f32 bulk result;
- `solver_mode`: one solver-mode step of the kernel model (at most 16
  shards);
- `multi_slice`: `slice_size` max(2, N/2) (at least 4 shards), overlap
  against the pallas bulk result in global numbering within 1e-4.

    python -m cfd_proxy_tpu_torch.tools.dryrun --n 8 --out dryrun_8.json
"""

from __future__ import annotations

import argparse
import json
import time
import traceback

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.models.gradients_ell import GreenGaussModel
from cfd_proxy_tpu_torch.utils.errors import check

PALLAS_CAP = 64     # shards of the kernel-model legs
SOLVER_CAP = 16     # shards of the solver-mode leg
BF16 = {"src_dtype": "bfloat16", "meta_dtype": "bfloat16",
        "halo_dtype": "bfloat16", "grad_dtype": "bfloat16"}


def dryrun(n: int, device: str) -> dict[str, str]:
    """One step of every leg at n shards; {leg: "ran ..." or "skipped
    ..."}.  Raises CheckError when a leg's results disagree."""
    legs: dict[str, str] = {}
    nx = max(8, int(round((2 * n) ** (1 / 3))) + 6)
    m = generate_mesh(nx, nx, nx, jitter=0.05, diag_frac=0.2, seed=0)
    gvar = make_state(m.npoint, 7, seed=1)
    parts = partition_mesh(m, n, ghost_layers=2)
    model = GreenGaussModel(parts, 7, dtype=torch.float32, device=device)
    var = model.distribute_state(gvar)
    outs = {s: model.step(var, s) for s in ("bulk", "early", "overlap")}
    for s in ("early", "overlap"):
        err = float((outs[s] - outs["bulk"]).abs().max())
        check(err < 1e-4, "xla: %s diverges from bulk: %g", s, err)
    legs["xla"] = f"ran at {n} shards, 2-layer ghosts, all 3 schedules"

    if n > PALLAS_CAP:
        parts = partition_mesh(m, PALLAS_CAP, ghost_layers=1)
    pmodel = GreenGaussTorch(parts, 7, bp=128, device=device)
    pstate = pmodel.distribute_state(gvar)
    pouts = {s: pmodel.step(pstate, s) for s in ("bulk", "early", "overlap")}
    scale = max(1.0, float(pouts["early"].abs().max()))
    err = float((pouts["overlap"] - pouts["early"]).abs().max()) / scale
    check(err < 1e-6, "pallas: fused overlap diverges from early: %g", err)
    err = float((pouts["bulk"] - pouts["early"]).abs().max())
    check(err < 1e-4, "pallas: early vs bulk: %g", err)
    legs["pallas"] = (f"ran at {len(parts)} shards (fused overlap kernel, "
                      f"{pmodel.nphases} phases), all 3 schedules")

    bmodel = GreenGaussTorch(parts, 7, bp=128, device=device, **BF16)
    bstate = bmodel.distribute_state(gvar, schedules=["overlap"])
    bg = bmodel.step(bstate, "overlap").float()
    scale = max(1.0, float(pouts["bulk"].abs().max()))
    err = float((bg - pouts["bulk"]).abs().max()) / scale
    check(0 < err < 2e-2, "reduced precision: bf16 stack vs f32 bulk: %g",
          err)
    legs["reduced_precision"] = (
        f"ran at {len(parts)} shards (src+meta+halo+grad bf16, overlap "
        f"schedule, rel err {err:.1e} vs f32 bulk)")

    if len(parts) <= SOLVER_CAP:
        v = pmodel.iterate_fn("bulk", 1, solver_mode=True)(
            *pmodel.iter_args(pstate))
        check(bool(torch.isfinite(v).all()), "solver mode: non-finite state")
        legs["solver_mode"] = f"ran at {len(parts)} shards"
    else:
        legs["solver_mode"] = (f"skipped ({len(parts)} shards > "
                               f"{SOLVER_CAP})")

    if len(parts) >= 4:
        size = max(2, len(parts) // 2)
        smodel = GreenGaussTorch(parts, 7, bp=128, device=device,
                                 slice_size=size)
        sg = smodel.step(smodel.distribute_state(gvar), "overlap")
        # global numbering: slice_size changes the phase coloring and so
        # the relabel, so the two models' device columns differ
        err = float(np.abs(smodel.gather_global(sg)
                           - pmodel.gather_global(pouts["bulk"])).max())
        check(err < 1e-4, "multi-slice overlap vs bulk: %g", err)
        legs["multi_slice"] = (f"ran at {len(parts)} shards, slice_size="
                               f"{size} ({len(smodel.kernel_phases)} phases "
                               f"in the kernel, {len(smodel.coll_phases)} "
                               f"through the transport)")
    else:
        legs["multi_slice"] = f"skipped ({len(parts)} shards < 4)"
    return legs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.dryrun")
    ap.add_argument("--n", type=int, default=8, help="shards")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="write the JSON line here")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    ok, err, legs = True, None, None
    try:
        legs = dryrun(args.n, args.device)
    except Exception as e:  # noqa: BLE001 -- the record carries the failure
        traceback.print_exc()
        ok, err = False, f"{type(e).__name__}: {e}"
    kind = (torch.cuda.get_device_name(0) if args.device == "cuda"
            and torch.cuda.is_available() else args.device)
    rec = {"n_shards": args.n, "device": kind, "ok": ok, "error": err,
           "wall_s": round(time.perf_counter() - t0, 1),
           "date": time.strftime("%Y-%m-%d"), "legs": legs}
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
