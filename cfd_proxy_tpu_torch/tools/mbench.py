"""Model-level paired A/B benchmark of the port — kbench's drift-cancelling
method applied to the whole model path (sweeps, exchange, scale), not one
kernel.

Counterpart of `cfd_proxy_tpu/tools/mbench.py`.  Step medians on the card
swing between calls at equal device time (PERF.md: P=8 steps by up to 75
%), so single runs cannot decide levers of 5-20 %.  This tool pairs two
model configurations of the port (`solver.SolverConfig`, built by
`solver.build_model` on one shared mesh and partition) through the
solver's chained-loop two-point method (`GreenGaussTorch.iterate_fn`,
`utils.timing.two_point_sampler`, each loop ended by a device
synchronise), interleaving samples in alternating order (A,B then B,A,
...) so slow drift and any run-second bias cancel in the per-pair ratio.

Usage (override strings are comma-separated SolverConfig field=value):

    python -m cfd_proxy_tpu_torch.tools.mbench --nx 96 --iters 300 \\
        --repeats 8 --a src_dtype=bfloat16,meta_dtype=bfloat16 \\
        --b src_dtype=bfloat16,meta_dtype=bfloat16,grad_dtype=bfloat16

    # schedule A/B on one model (configs equal -> the model is shared):
    python -m cfd_proxy_tpu_torch.tools.mbench --a schedule=bulk \\
        --b schedule=early

`--device cpu` runs the plain PyTorch versions (mechanics only: its times
are the CPU's).  Output: the median per-pair ratio A/B with its IQR (ratio
> 1 means B is faster), each side's median step time and faces/s, and a
null calibration (consecutive side-A samples, whose ratio should center on
1).  Model fields of the reference the port does not build are refused by
name (`REFUSED`), never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.solver import (SolverConfig, _sync, build_model,
                                        check_config)
from cfd_proxy_tpu_torch.utils.errors import CheckError, check
from cfd_proxy_tpu_torch.utils.timing import two_point_sampler

# SolverConfig fields that change the constructed model (everything else —
# schedule, iters, warmup — only changes how it is driven)
_MODEL_FIELDS = (
    "model", "nvar", "bp", "kernel", "force_rdma", "meta_dtype",
    "src_dtype", "kcompact", "halo_dtype", "grad_dtype", "backend",
    "min_phases", "fake_sends", "fake_tail_frac",
)

# fields the per-side drive honors (schedule, mode, state seed).  Everything
# else — nx/ny/nz/parts/ghost_layers/jitter/stretch/diag_frac, iters,
# dtype, ... — is taken from the shared base mesh and command line and
# would be silently ignored as a per-side override, recording a false ~1.00
# "this lever does nothing" verdict; those are rejected up front.
_DRIVE_FIELDS = ("schedule", "solver_mode", "sweeps_per_step", "seed",
                 "verify")

# the reference's model fields the port does not build, with the ROADMAP
# item that brings each
REFUSED = {
    "overlap_debug": "its fused-kernel attribution rungs work around the "
                     "TPU and are not ported (ROADMAP queue 2, not-ported "
                     "list)",
    "pack_force": "the pack lowerings it picks work around XLA and are not "
                  "ported (ROADMAP queue 2, not-ported list)",
    "slice_size": "multi-node phase routing comes with ROADMAP queue 1 "
                  "item 12",
}


def _coerce(field: dataclasses.Field, raw: str):
    # SolverConfig annotations are strings ("int | None", "bool", ...) —
    # coerce by annotation first so None-default numerics (bp) don't leak
    # through as raw strings
    t = str(field.type)
    if raw == "None":
        return None
    if "bool" in t or isinstance(field.default, bool):
        return raw.lower() in ("1", "true", "on", "yes")
    if "int" in t or (isinstance(field.default, int)
                      and not isinstance(field.default, bool)):
        return int(raw)
    if ("float" in t and "str" not in t) or isinstance(field.default, float):
        return float(raw)
    return raw


def parse_overrides(base: SolverConfig, spec: str) -> SolverConfig:
    """Apply "k=v,k=v" overrides to a SolverConfig copy."""
    if not spec:
        return base
    fields = {f.name: f for f in dataclasses.fields(SolverConfig)}
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        check("=" in item, "override %r is not field=value", item)
        k, v = item.split("=", 1)
        if k in REFUSED:
            raise CheckError(f"field {k!r}: {REFUSED[k]}")
        check(k in fields, "unknown SolverConfig field %r (have: %s)",
              k, ", ".join(sorted(fields)))
        check(k in _MODEL_FIELDS + _DRIVE_FIELDS,
              "field %r cannot differ between A and B: the mesh and "
              "partitions are shared by both sides (set --nx/--ny/--nz/"
              "--parts/--iters at top level); per-side overrides may be: %s",
              k, ", ".join(sorted(_MODEL_FIELDS + _DRIVE_FIELDS)))
        # kcompact is tri-state in the config (None=auto); case-insensitive,
        # and an unknown spelling is an error rather than a silent False
        if k == "kcompact":
            vmap = {"auto": None, "none": None, "on": True, "true": True,
                    "1": True, "off": False, "false": False, "0": False}
            check(v.lower() in vmap, "kcompact=%r (use on/off/auto)", v)
            out[k] = vmap[v.lower()]
        else:
            out[k] = _coerce(fields[k], v)
    return dataclasses.replace(base, **out)


def _sampler(model, cfg: SolverConfig, iters: int):
    """Warm the two chained runners of one side; return a zero-arg function
    producing one two-point per-iteration sample (or None below the noise
    floor)."""
    npoint = sum(p.nowned for p in model.parts)
    state = make_state(npoint, cfg.nvar, seed=cfg.seed + 1)
    scheds = [cfg.schedule] if cfg.schedule != "all" else None
    st = model.distribute_state(state, schedules=scheds)
    n0 = max(1, iters // 10)
    small = model.iterate_fn(cfg.schedule, n0, cfg.solver_mode,
                             cfg.sweeps_per_step)
    big = model.iterate_fn(cfg.schedule, n0 + iters, cfg.solver_mode,
                           cfg.sweeps_per_step)
    args = model.iter_args(st)

    def run(fn):
        fn(*args)
        _sync(model.device)

    run(small)
    run(big)
    return two_point_sampler(lambda: run(small), lambda: run(big), iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cfd_proxy_tpu_torch.tools.mbench",
        description="paired model-path A/B (see module docstring)")
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--nz", type=int, default=None)
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--repeats", type=int, default=8,
                    help="paired sample count (each is one A,B interleave)")
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed settling pairs before sampling")
    ap.add_argument("--schedule", default="bulk")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hub-frac", type=float, default=0.0,
                    help="high-valence tail stress mesh (shared by both "
                         "sides; see generator hub mode)")
    ap.add_argument("--hub-extra", type=int, default=12)
    ap.add_argument("--a", default="", metavar="K=V,...",
                    help="SolverConfig overrides for side A")
    ap.add_argument("--b", default="", metavar="K=V,...",
                    help="SolverConfig overrides for side B")
    ap.add_argument("--null", type=int, default=3, metavar="N",
                    help="null calibration pairs of this run: N pairs of "
                         "consecutive side-A samples whose ratio should "
                         "center on 1.0 (0 disables)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the table")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernels; cpu: their plain versions")
    args = ap.parse_args(argv)

    base = SolverConfig(
        nx=args.nx, ny=args.ny or max(args.nx // 4, 8),
        nz=args.nz or max(args.nx // 4, 8), parts=args.parts,
        iters=args.iters, schedule=args.schedule, seed=args.seed,
        hub_frac=args.hub_frac, hub_extra=args.hub_extra,
        device=args.device, verify=False,
    )
    try:
        cfg_a = parse_overrides(base, args.a)
        cfg_b = parse_overrides(base, args.b)
        for c in (cfg_a, cfg_b):
            check_config(c)
    except CheckError as e:
        ap.error(str(e))
    for side, c in (("a", cfg_a), ("b", cfg_b)):
        if c.schedule == "all":
            ap.error(f"--{side}: pick ONE schedule per side")

    m = generate_mesh(base.nx, base.ny, base.nz, jitter=base.jitter,
                      diag_frac=base.diag_frac, seed=base.seed,
                      stretch=base.stretch, hub_frac=base.hub_frac,
                      hub_extra=base.hub_extra)
    parts = partition_mesh(m, base.parts, ghost_layers=base.ghost_layers)
    nface = sum(p.nface for p in parts)
    print(f"mesh {base.nx}x{base.ny}x{base.nz}: {nface} faces, "
          f"{base.parts} part(s)", file=sys.stderr)

    model_a, _ = build_model(cfg_a, parts)
    shared = all(getattr(cfg_a, f) == getattr(cfg_b, f)
                 for f in _MODEL_FIELDS)
    model_b = model_a if shared else build_model(cfg_b, parts)[0]
    if shared:
        print("configs share one model (only the drive differs)",
              file=sys.stderr)

    sample_a = _sampler(model_a, cfg_a, args.iters)
    sample_b = _sampler(model_b, cfg_b, args.iters)

    for _ in range(max(0, args.warmup)):
        sample_a(), sample_b()

    # null calibration: consecutive same-runner samples — the ratio
    # distribution's center is the harness's zero point for this run
    null_ratios = []
    for r in range(max(0, args.null)):
        t1, t2 = sample_a(), sample_a()
        if t1 is None or t2 is None:
            continue
        null_ratios.append(t1 / t2)
        print(f"null {r}: {t1 * 1e3:.4f} / {t2 * 1e3:.4f} ms  "
              f"ratio {t1 / t2:.4f}", file=sys.stderr)

    ratios, ta_all, tb_all, skipped = [], [], [], 0
    for r in range(args.repeats):
        # alternate the order within a pair (A,B then B,A) so a systematic
        # run-second effect cancels across pairs
        if r % 2 == 0:
            ta, tb = sample_a(), sample_b()
        else:
            tb, ta = sample_b(), sample_a()
        if ta is None or tb is None:
            skipped += 1
            continue
        ta_all.append(ta)
        tb_all.append(tb)
        ratios.append(ta / tb)
        print(f"pair {r}: A {ta * 1e3:.4f} ms  B {tb * 1e3:.4f} ms  "
              f"ratio {ta / tb:.4f}", file=sys.stderr)

    if not ratios:
        print("every sample below the dispatch-noise floor — mesh too small "
              "for --iters; raise --iters", file=sys.stderr)
        return 1

    med = float(np.median(ratios))
    q1, q3 = (float(np.percentile(ratios, q)) for q in (25, 75))
    ma, mb = float(np.median(ta_all)), float(np.median(tb_all))
    out = {
        "device": model_a.device.type,
        "nface": nface,
        "schedule_a": cfg_a.schedule, "schedule_b": cfg_b.schedule,
        "a": args.a or "(base)", "b": args.b or "(base)",
        "pairs": len(ratios), "skipped": skipped,
        "ratio_a_over_b": med, "iqr": [q1, q3],
        "a_ms": ma * 1e3, "b_ms": mb * 1e3,
        "a_gfps": nface / ma / 1e9, "b_gfps": nface / mb / 1e9,
        "null_ratio": (float(np.median(null_ratios)) if null_ratios
                       else None),
        "null_pairs": len(null_ratios),
    }
    if args.json:
        print(json.dumps(out))
    else:
        nr = (f"  null={out['null_ratio']:.4f} (n={out['null_pairs']})"
              if out["null_ratio"] is not None else "")
        print(f"A [{out['a']}] {out['a_ms']:.4f} ms = {out['a_gfps']:.4g} "
              f"Gf/s\nB [{out['b']}] {out['b_ms']:.4f} ms = "
              f"{out['b_gfps']:.4g} Gf/s\n"
              f"paired ratio A/B: {med:.4f}  IQR [{q1:.4f}, {q3:.4f}]  "
              f"n={len(ratios)}" + (f"  ({skipped} below noise)"
                                    if skipped else "") + nr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
