"""Analytic multi-GPU scaling model — MODEL, not measurement.

Counterpart of `cfd_proxy_tpu/tools/scaling_model.py`, on the port's own
host modules and the H100's measured rates.  One card cannot show whether
the overlapped exchange strong-scales past where bulk-sync flattens, so
this tool predicts it: it partitions a REAL mesh, takes each shard's exact
face counts (boundary vs interior) and padded halo volumes from the port's
own layout, and combines them with

- the MEASURED single-card sweep rate per shard size (RATE_TABLES: the P=1
  `bulk` step of `python -m cfd_proxy_tpu_torch.solver` over its faces),
- the MEASURED per-step exchange chain (base cost and pack cost per
  gathered column, from the P=1 fake-phase rungs),
- an ASSUMED link bandwidth: NVLink between the GPUs of a node, InfiniBand
  between nodes (`--slice-size`),

under the three schedule dataflows:

    bulk    : t_sweep(all faces) + t_comm + chain      (serialized)
    early/
    overlap : t_sweep(boundary) + max(t_sweep(interior), t_comm) + chain

Per-GPU time is the max over shards (the benchmark barrier).  Prints a
strong-scaling table with predicted overlap efficiency; every input is
printed so the numbers can be re-derived.  Host NumPy only: it imports no
torch and touches no GPU.

    python -m cfd_proxy_tpu_torch.tools.scaling_model --nx 96 --parts 1 2 4 8 16 64

The tables and the chain's defaults are re-measured on a card with
`python -m cfd_proxy_tpu_torch.tools.scaling_inputs rates|chain`.
"""

from __future__ import annotations

import argparse

import numpy as np

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh, send_point_set

# the card every measured input below comes from (nvidia-smi name, power.limit)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

# MEASURED single-card sweep rates vs shard size (ns/face): the P=1 `bulk`
# step median over nface — compact packed kernel, AUTO bp, the chained
# update included, the chained loop the step's CUDA graphs replayed
# (models/compiled.py) — on CARD, each row from one run of `scaling_inputs
# rates --nx 24 32 50 96 160 224 288` (C), with its nx, step ms and peak
# device memory; the nx=352 row from an earlier run with the step launched
# op by op (B: `--nx 96 352 --rate f32`), where the host's launches are
# well under 1 % of a 9.4 ms step.  Up to ~100 k faces the step sits on
# the card's own floor (0.011-0.012 ms: the graph's K1, zero fill and the
# update's mul and add, back to back), so ns/face falls as 1/size; from
# 2.8 M faces on the sweep covers them and the rate is the kernel's
# plateau.
RATE_TABLES = {
    "f32": [
        (42_179, 0.2527),       # nx=24, 0.01066 ms, H100 700 W, C
        (101_177, 0.1213),      # nx=32, 0.01227 ms, H100 700 W, C
        (390_934, 0.0913),      # nx=50, 0.03568 ms, H100 700 W, C
        (2_798_223, 0.0723),    # nx=96, 0.20225 ms, H100 700 W, C; 0.63 GB
        (13_014_957, 0.0687),   # nx=160, 0.89435 ms, H100 700 W, C
        (35_785_859, 0.0678),   # nx=224, 2.42635 ms, H100 700 W, C
        (76_138_925, 0.0675),   # nx=288, 5.13904 ms, H100 700 W, C; 16.8 GB
        (139_118_258, 0.0674),  # nx=352, 9.37279 ms, H100 700 W, B; 32.0 GB
    ],
    # reduced precision = --src-dtype/--meta-dtype bfloat16
    "reduced": [
        (42_179, 0.2609),       # nx=24, 0.01100 ms, H100 700 W, C
        (101_177, 0.1198),      # nx=32, 0.01212 ms, H100 700 W, C
        (390_934, 0.0715),      # nx=50, 0.02796 ms, H100 700 W, C
        (2_798_223, 0.0607),    # nx=96, 0.16993 ms, H100 700 W, C
        (13_014_957, 0.0568),   # nx=160, 0.73949 ms, H100 700 W, C
        (35_785_859, 0.0560),   # nx=224, 2.00320 ms, H100 700 W, C
        (76_138_925, 0.0556),   # nx=288, 4.23579 ms, H100 700 W, C; 12.4 GB
    ],
}


def rate_ns_per_face(nface: int, table) -> float:
    """Log-size linear interpolation over a measured (nface, ns/face) table,
    clamped to the end rates outside the measured range."""
    pts = sorted(table)
    x = np.log([p[0] for p in pts])
    y = [p[1] for p in pts]
    return float(np.interp(np.log(max(nface, 1)), x, y))


# Interconnect ASSUMPTIONS (one card cannot measure a wire): NVLink 4 of an
# H100 SXM5 moves 450 GB/s per direction to one peer through NVSwitch (the
# spec's 900 GB/s bidirectional); across nodes one 400 Gb/s InfiniBand NDR
# port per GPU gives 50 GB/s.
NVLINK_GBPS = 450.0
IB_NDR_GBPS = 50.0


def scale_rate_table(table, factor: float):
    """Scale a measured (nface, ns/face) table's rates by `factor` (e.g. the
    ratio of two cards' HBM rates, to project the memory-bound sweep onto
    another card).  Valid only where the kernel is at its memory floor —
    plateau shard sizes; the small-shard rows are launch-bound."""
    return [(n, r * factor) for n, r in table]


def shard_geometry(mesh, P, slice_size=None) -> dict:
    """Partition once and extract the per-shard GEOMETRIC model inputs,
    built as `GreenGaussTorch` builds its layout (comm-first relabel on the
    pre-topology's phase ids, then `build_tlayout`):

        (nface, boundary faces, ICI sends, DCN sends, pack_cols, 0)

    per shard, plus nface_total and the padded phase width s_max.  The
    first four entries are the reference's; ICI/DCN mean the phases inside
    a node (NVLink) and across nodes (`slice_size`).  The pack pair is the
    port's: `GreenGaussTorch._pack` is ONE index gather of the whole
    (P, nphases, rows, s_max) send buffer, self-phases included, whenever
    some phase moves data, so every shard gathers nphases × s_max columns;
    the port has no tail gather, so the last entry is 0."""
    from cfd_proxy_tpu_torch.mesh.partition import (rcb_owned_order,
                                                    relabel_owned)
    from cfd_proxy_tpu_torch.parallel.tlayout import build_tlayout
    from cfd_proxy_tpu_torch.parallel.topology import (build_halo_topology,
                                                       entry_phases)

    raw = partition_mesh(mesh, P)
    pre = build_halo_topology(raw, max(p.npoint for p in raw) + 1,
                              slice_size=slice_size)
    eph = entry_phases(raw, pre)
    parts = [relabel_owned(p, rcb_owned_order(p, block=4096,
                                              degree_sort=True,
                                              entry_phase=eph[d]))
             for d, p in enumerate(raw)]
    topo = build_halo_topology(parts, max(p.npoint for p in parts) + 1,
                               slice_size=slice_size)
    lay = build_tlayout(parts, topo)
    inter = np.asarray(lay.inter_slice, bool)
    moves = any(len(p) for p in lay.perms)
    pack_cols = lay.nphases * int(lay.s_max) if moves else 0
    shards = []
    for d, p in enumerate(parts):
        sp = send_point_set(p)
        is_send = np.zeros(p.npoint, bool)
        is_send[sp] = True
        bsel = is_send[p.faces[:, 0]] | is_send[p.faces[:, 1]]
        sends = lay.dsts[d] != d
        shards.append((p.nface, int(bsel.sum()),
                       int((sends & ~inter).sum()),
                       int((sends & inter).sum()), pack_cols, 0))
    return {"nface_total": sum(p.nface for p in parts),
            "s_max": int(lay.s_max), "shards": shards}


def eval_geometry(geo: dict, ns_per_face, ici_gbps, rows, *,
                  overlap_fixed_us=0.0, halo_bytes=4, rate_table=None,
                  bulk_fixed_us=0.0, dcn_gbps=None,
                  pack_ns_per_col=None, pack_tail_gather_us=0.85,
                  pack_tail_phase_us=0.55) -> dict:
    """Evaluate the schedule time model on a shard_geometry (the
    reference's code).

    Schedule dataflows (per shard; per-GPU time = max over shards — the
    benchmark barrier):
        bulk    : t_sweep(all) + t_comm + bulk_fixed      (serialized)
        overlap : t_sweep(boundary) + max(t_sweep(interior), t_comm)
                  + overlap_fixed
        nocomm  : t_sweep(all)                            (the floor)

    bulk_fixed_us / overlap_fixed_us: each schedule's per-step chain BASE
    beyond the sweep (launches, transport, unpack; the fused kernel's
    push), charged only when the shard exchanges.  pack_ns_per_col: when
    set, both schedules also pay pack_ns_per_col × the shard's gathered
    columns (`pack_cols`; for the port every column of the send buffer).
    The tail terms apply to shards with tail phases, which the port's
    geometry never has.

    Multi-node: a geometry built with slice_size carries DCN (inter-node)
    phase counts, charged at dcn_gbps.

    Returns both overlap-efficiency definitions: eff_hide = Σ min(t_interior,
    t_comm) / Σ t_comm (fixed costs excluded), and eff_solverdef = 1 −
    (t_over − t_nocomm)/(t_bulk − t_nocomm), what `solver.run` computes
    from measured medians.
    """
    t_bulk = t_over = t_nc = 0.0
    eff_num = eff_den = 0.0
    for shard in geo["shards"]:
        nface, nfb, n_ici, n_dcn = shard[:4]
        pack_cols = (shard[4] if len(shard) > 4
                     else (n_ici + n_dcn) * geo["s_max"])
        n_tail_ph = shard[5] if len(shard) > 5 else 0
        # per-SHARD sweep rate: a strong-scaled shard runs at its own
        # footprint's measured rate (RATE_TABLES), not the global mesh's
        nspf = (rate_ns_per_face(nface, rate_table) if rate_table
                else ns_per_face)
        nfi = nface - nfb
        phase_bytes = geo["s_max"] * rows * halo_bytes
        ts_all = nface * nspf * 1e-9
        ts_b = nfb * nspf * 1e-9
        ts_i = nfi * nspf * 1e-9
        tc = n_ici * phase_bytes / (ici_gbps * 1e9)
        if n_dcn:
            tc += n_dcn * phase_bytes / ((dcn_gbps or ici_gbps) * 1e9)
        fx = bulk_fixed_us * 1e-6 if (n_ici + n_dcn) else 0.0
        ofx = overlap_fixed_us * 1e-6 if (n_ici + n_dcn) else 0.0
        if pack_ns_per_col is not None and (n_ici + n_dcn):
            tp = pack_cols * pack_ns_per_col * 1e-9
            if n_tail_ph:
                # mixed-layout fixed terms: one combined tail gather +
                # per-tail-phase concat materialization
                tp += (pack_tail_gather_us
                       + pack_tail_phase_us * n_tail_ph) * 1e-6
            fx += tp
            ofx += tp
        t_bulk = max(t_bulk, ts_all + tc + fx)
        t_over = max(t_over, ts_b + max(ts_i, tc) + ofx)
        t_nc = max(t_nc, ts_all)
        eff_num += min(ts_i, tc)
        eff_den += tc
    comm = t_bulk - t_nc
    return {
        "nface": geo["nface_total"],
        "t_bulk": t_bulk,
        "t_over": t_over,
        "t_nocomm": t_nc,
        "eff_hide": eff_num / eff_den if eff_den else None,
        "eff_solverdef": (max(0.0, min(1.0, 1.0 - (t_over - t_nc) / comm))
                          if comm > 0 else None),
    }


def model_partitioning(mesh, P, ns_per_face, ici_gbps, rows,
                       overlap_fixed_us=0.0, halo_bytes=4, rate_table=None,
                       bulk_fixed_us=0.0, slice_size=None, dcn_gbps=None):
    """Back-compat wrapper: shard_geometry + eval_geometry in one call,
    returning the (nface_total, t_bulk, t_over, eff_hide) tuple."""
    geo = shard_geometry(mesh, P, slice_size=slice_size)
    r = eval_geometry(geo, ns_per_face, ici_gbps, rows,
                      overlap_fixed_us=overlap_fixed_us,
                      halo_bytes=halo_bytes, rate_table=rate_table,
                      bulk_fixed_us=bulk_fixed_us, dcn_gbps=dcn_gbps)
    return r["nface"], r["t_bulk"], r["t_over"], r["eff_hide"]


# the exchange chain's defaults, MEASURED on CARD by `scaling_inputs chain`
# (P=1, 48³, 6 fake phases × 1024 / 2432 / 4096 sends, 24 rows f32, the
# chained loop the step's CUDA graphs replayed): the bases are the step-time
# medians of bulk - nocomm and overlap - nocomm less the pack term; the
# pack term is the slope of the pack and unpack's device time over the
# gathered columns (the step's own slope, 0.341 ns/col, agrees)
# (`scaling_inputs chain`: 9 points, H100 700 W)
BULK_FIXED_US = 23.666      # 9 points from 24.2 to 33.5 us
PACK_NS_PER_COL = 0.30868   # device 21.4 / 24.3 / 27.1 us at 6k / 15k / 25k
OVERLAP_FIXED_US = 30.009   # 9 points from 30.4 to 38.3 us
CHAIN_NOTE = ("the P=1 fake-phase chain's bulk - nocomm and overlap - "
              "nocomm less the pack's device slope: the device work of "
              "pack, Loopback's copy and unpack (overlap: zero fill, "
              "boundary sweep, K3's push) in one graph, not a wire")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy_tpu_torch.tools.scaling_model")
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ny", type=int, default=0)
    ap.add_argument("--nz", type=int, default=0)
    ap.add_argument("--parts", type=int, nargs="+", default=[1, 2, 4, 8, 16, 64])
    ap.add_argument("--ns-per-face", type=float, default=None,
                    help="CONSTANT sweep-rate override, ns/face.  Default "
                         "(unset) uses the measured size-dependent rate "
                         f"table (RATE_TABLES, {CARD}): each shard is "
                         "modeled at its own footprint's rate")
    ap.add_argument("--rate", choices=sorted(RATE_TABLES), default="f32",
                    help="which measured rate table to use (f32 = the "
                         "packed kernel; reduced = bf16 source deltas and "
                         "weights, --src-dtype/--meta-dtype bfloat16)")
    ap.add_argument("--ici-gbps", type=float, default=NVLINK_GBPS,
                    help="ASSUMED NVLink bandwidth per direction between two "
                         "GPUs of a node, GB/s (H100 SXM5 through NVSwitch, "
                         "by the spec; one card cannot measure it — "
                         "tools/icibench.py times the push on one card)")
    ap.add_argument("--rows", type=int, default=24,
                    help="exchanged rows per point (24 = gg grads; 8 = flux)")
    ap.add_argument("--halo-bytes", type=int, default=4, choices=[2, 4],
                    help="wire bytes per exchanged value (4 = f32; 2 = the "
                         "--halo-dtype bfloat16 payload option)")
    ap.add_argument("--overlap-fixed-us", type=float,
                    default=OVERLAP_FIXED_US,
                    help="overlap schedule's per-step chain BASE beyond the "
                         "pack, MEASURED on the H100: the median of overlap "
                         "- nocomm of the P=1 fake-phase chain less the pack "
                         "term (zero fill, boundary sweep, K3's in-kernel "
                         "push through Loopback, unpack); the wire is "
                         "t_comm")
    ap.add_argument("--slice-size", type=int, default=None,
                    help="GPUs per node (multi-node deployments): inter-node "
                         "phases are charged at --dcn-gbps instead of "
                         "--ici-gbps, mirroring the node-first/inter-node-"
                         "separated phase coloring the port runs "
                         "(parallel/topology.py)")
    ap.add_argument("--dcn-gbps", type=float, default=IB_NDR_GBPS,
                    help="ASSUMED inter-node bandwidth per GPU, GB/s (one "
                         "400 Gb/s InfiniBand NDR port per GPU; only used "
                         "with --slice-size)")
    ap.add_argument("--bulk-fixed-us", type=float, default=BULK_FIXED_US,
                    help="bulk/early schedules' per-step chain BASE, MEASURED "
                         "on the H100: the median of bulk - nocomm of the "
                         "P=1 fake-phase chain (48^3, 6 phases x 1024/2432/"
                         "4096 sends) less the pack term: the launches of "
                         "pack, Loopback's copy and unpack, which bound the "
                         "step there (Loopback's device copy stands in for "
                         "the wire, charged apart as t_comm); the payload "
                         "term lives in --pack-ns-per-col")
    ap.add_argument("--pack-ns-per-col", type=float, default=PACK_NS_PER_COL,
                    help="MEASURED pack cost per gathered send column, "
                         "charged to BOTH schedules: the slope of the pack "
                         "and unpack's device time over the gathered columns "
                         "(24 rows f32; the port's pack gathers every column "
                         "of the send buffer, nphases x s_max)")
    ap.add_argument("--diag-frac", type=float, default=0.2)
    args = ap.parse_args(argv)

    mesh = generate_mesh(args.nx, args.ny or args.nx, args.nz or args.nx,
                         jitter=0.05, diag_frac=args.diag_frac, seed=0)
    rate_table = None if args.ns_per_face is not None else RATE_TABLES[args.rate]
    if rate_table is not None:
        rate_s = (f"measured {args.rate} rate table ({CARD}; whole mesh "
                  f"{rate_ns_per_face(mesh.nface, rate_table):.4f} ns/face; "
                  f"per-shard at each shard's footprint)")
    else:
        rate_s = f"{args.ns_per_face} ns/face constant (override)"
    slice_s = (f"slice_size={args.slice_size} (DCN phases at "
               f"{args.dcn_gbps} GB/s InfiniBand, ASSUMED), "
               if args.slice_size else "")
    print(f"# MODEL (not measurement): {mesh.nface} global faces, "
          f"sweep = {rate_s}, {slice_s}"
          f"{args.ici_gbps} GB/s NVLink (ASSUMED), "
          f"rows={args.rows}, overlap base {args.overlap_fixed_us} us + "
          f"bulk base {args.bulk_fixed_us} us + pack "
          f"{args.pack_ns_per_col} ns/col (measured on {CARD}: {CHAIN_NOTE}"
          f"); faces/sec uses sum-of-shard faces (solver.run)")
    print(f"{'P':>4} {'shard ns/f':>10} {'bulk Gf/s':>10} "
          f"{'overlap Gf/s':>13} {'speedup':>8} {'eff_hide':>9} "
          f"{'eff_slvr':>9}")
    base = None
    for P in args.parts:
        geo = shard_geometry(mesh, P, slice_size=args.slice_size)
        r = eval_geometry(
            geo, args.ns_per_face, args.ici_gbps, args.rows,
            overlap_fixed_us=args.overlap_fixed_us,
            halo_bytes=args.halo_bytes, rate_table=rate_table,
            bulk_fixed_us=args.bulk_fixed_us, dcn_gbps=args.dcn_gbps,
            pack_ns_per_col=args.pack_ns_per_col)
        nface_total, t_bulk, t_over = r["nface"], r["t_bulk"], r["t_over"]
        if base is None:
            base = t_over
        shard_rate = (rate_ns_per_face(mesh.nface // P, rate_table)
                      if rate_table else args.ns_per_face)

        def pct(v):
            return f"{v:>9.1%}" if v is not None else f"{'-':>9}"

        # eff_hide: pure hide ratio (fixed costs excluded); eff_slvr:
        # solver.run's measured definition 1 - (over-nocomm)/(bulk-nocomm)
        print(f"{P:>4} {shard_rate:>10.4f} {nface_total / t_bulk / 1e9:>10.2f} "
              f"{nface_total / t_over / 1e9:>13.2f} "
              f"{base / t_over:>8.2f} {pct(r['eff_hide'])} "
              f"{pct(r['eff_solverdef'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
