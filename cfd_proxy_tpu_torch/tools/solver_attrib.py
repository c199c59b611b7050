"""Solver-mode attribution: time the per-step body with parts knocked out.

Counterpart of `cfd_proxy_tpu/tools/solver_attrib.py`.  The solver-mode
step is the full per-time-step dataflow (table rebuild + sweep with its
exchange + the state update + the var halo exchange); this tool times it
with components removed, each body a chained loop timed by the solver's
two-point method (`utils.timing.two_point_sampler`, each loop ended by a
device synchronise), one shard, the bulk schedule:

    noop        loop + toy update + var exchange only (the floor)
    extsonly    + the per-block ext-column tables (`gather_exts`)
    tablesonly  + the source pack too (packed kernel: K4), i.e. the
                full table rebuild
    sweeponly   sweep + update on the state's fixed tables (the proxy's
                static regime)
    all         the full solver-mode body

Each body keeps the reference's data dependences: the knocked-out parts
still feed the next step (a 1e-60 multiple of the tables' sum, a 1e-30
multiple of the gradients; `knockout_fn(..., coupling=c)` takes c and
c·1e-30 instead, where a check must see them in the state), so no part can
be skipped.  Each runs as the
solver-mode runner does (`models/compiled.py`): on the card the body
captured as CUDA graphs and replayed, eagerly on the CPU.  The times below were taken
eagerly, before the graph dispatch (PERF.md §6 has both).

On an NVIDIA H100 80GB HBM3 at a 700 W limit (96³, 2.8 M faces, one shard;
chip_smoke.py's `solver_attrib` phase), ms per step, noop / extsonly /
tablesonly / sweeponly / all: packed at the AUTO bp 4096 0.018 / 0.092 /
0.200 / 0.203 / 0.309, gather at bp 512 0.018 / 0.085 / 0.088 / 0.144 /
0.181.  In the packed step the rebuild alone (the ext gather and K4) and
the sweep alone each take about two thirds of the full body; the gather
step has no pack to rebuild and a cheaper sweep.

    python -m cfd_proxy_tpu_torch.tools.solver_attrib --mode noop all
    python -m cfd_proxy_tpu_torch.tools.solver_attrib --kernel gather \\
        --bp 512 --mode noop extsonly tablesonly sweeponly all

On the card this prints one line per mode (ms per step); `--device cpu`
runs the plain versions (mechanics only).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops.blocksweep import gather_exts
from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.utils.timing import two_point_sampler

MODES = ("noop", "extsonly", "tablesonly", "sweeponly", "all")


def knockout_fn(model: GreenGaussTorch, state: dict, mode: str,
                coupling: float = 1e-30, sink: torch.Tensor | None = None):
    """run(n, v0, graph=None): n chained steps of mode's body from the state
    v0, each ending in the var halo exchange, as the solver-mode step does;
    through `compiled.runner` under the model's dispatch rule, so on the
    card every mode's body is captured as CUDA graphs and replayed, as the
    solver-mode runner is (the same body, and so the same work knocked out,
    in either form; graph: as in `compiled.use_graph`).  coupling: the
    gradients' factor (the tables' is coupling·1e-30).  sink: a buffer each
    step copies what it computes into (the gradients of all and sweeponly,
    the rebuilt table of tablesonly), for a check of one replayed step."""
    check(mode in MODES, "unknown mode %r (one of %s)", mode, "/".join(MODES))
    ext_idx = model.plans["bulk"]["ext_idx"]
    c_tab = coupling * 1e-30

    def keep(x):
        if sink is not None:
            sink.copy_(x)
        return x

    def body(v, fixed, out=None):
        if mode == "all":
            tb = model._build_tables(v, ("bulk",))
            v2 = torch.add(v, coupling * keep(model(v, tb, "bulk"))[:, :NV],
                           out=out)
        elif mode == "sweeponly":
            v2 = torch.add(v, coupling * keep(model(v, fixed, "bulk"))[:, :NV],
                           out=out)
        elif mode == "tablesonly":
            tb = keep(model._build_tables(v, ("bulk",))["bulk"])
            v2 = torch.add(v, tb.float().sum() * c_tab, out=out)
        elif mode == "extsonly":
            v2 = torch.add(v, keep(gather_exts(v, ext_idx)).sum() * c_tab,
                           out=out)
        else:
            v2 = torch.mul(v, 1.0 + 1e-30, out=out)
        return model._var_exchange(v2)

    key = ("attrib", mode, coupling, None if sink is None else id(sink))

    def run(n, v0, graph=None):
        return compiled.runner(model, body, n, key, graph=graph)(
            v0, state["tables"])

    return run


def attribute(model: GreenGaussTorch, state: dict, modes, iters: int,
              repeats: int, graph: bool | None = None) -> dict:
    """{mode: the ms per step of each sample that cleared the noise
    floor}; graph: the runners' dispatch, as in `knockout_fn`."""
    n0 = max(1, iters // 10)
    v0 = state["var_T"]
    out = {}
    for mode in modes:
        run = knockout_fn(model, state, mode)

        def timed(n, run=run):
            run(n, v0, graph)
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)

        timed(n0)
        timed(n0 + iters)
        sample = two_point_sampler(lambda: timed(n0),
                                   lambda: timed(n0 + iters), iters)
        out[mode] = [v * 1e3 for v in (sample() for _ in range(repeats))
                     if v is not None]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.solver_attrib")
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--mode", nargs="+", default=["all"], choices=MODES)
    ap.add_argument("--kcompact", default="on", choices=["on", "off"])
    ap.add_argument("--kernel", default="packed",
                    choices=["packed", "gather"])
    ap.add_argument("--bp", type=int, default=None,
                    help="points per block (default: the model's AUTO rule)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    kc = args.kcompact == "on"
    m = generate_mesh(args.nx, args.nx, args.nx, jitter=0.05, diag_frac=0.2,
                      seed=0)
    model = GreenGaussTorch(partition_mesh(m, 1, ghost_layers=1), 7,
                            kcompact=kc, kernel=args.kernel, bp=args.bp,
                            device=args.device)
    state = model.distribute_state(make_state(m.npoint, 7, seed=1),
                                   schedules=["bulk"])
    rc = 0
    for mode, ms in attribute(model, state, args.mode, args.iters,
                              args.repeats).items():
        if not ms:
            print(f"mode={mode}: below the noise floor")
            rc = 1
            continue
        print(f"kcompact={kc} kernel={args.kernel} bp={model.bp} "
              f"mode={mode}: {float(np.median(ms)):.3f} ms/step "
              f"(n={len(ms)})")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
