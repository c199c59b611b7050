"""Kernel times of one checkout of the port at the smoke run's shapes, for
comparing two commits' source pack, push path and gather sweep on one card.

    python3 chip_turns.py --root DIR --label NAME
    python3 chip_turns.py --summary FILE

The first form imports the port from DIR (a checkout, such as an unpacked
`git archive` of another commit), builds its kernels, and prints one JSON
line with: the times of K4 and K4-bf16d as the model's table rebuild calls
them on the one-shard bulk table; K6 in mode full at 4 x 8 MB and 4 x 32 MB
per phase and in every mode at 1 x 0.125 MB; K3's peer form at the 8-shard
interior + push shapes (packed f32, gather at bp 512, packed full bf16
stack); the gather sweep at bp 512 as the model calls it (K2 and
K2-w16-o16 on the bulk plan at one and eight shards, K2-flux at eight;
K2-init, K2-init-w16-o16 and K2-flux-init on the eight-shard interior
plan; K3-gather, K3-gather-w16-o16 and K3-gather-flux at the eight-shard
interior + push shapes; the peer form is the K3-peer gather row above);
and
ptxas's registers and spill bytes of every K6, K3-peer and gather
instance.  The mesh is the smoke run's (96³, seed 0, nvar 7).  Times are
CUDA-event means of 50 calls (`chip_smoke.cuda_ms`), K6 back to back on the
card (`chip_smoke.kernel_device_ms`), both from DIR's `chip_smoke.py`.  Run
it on the two checkouts in turns (A, B, B, A), appending to one file; the
second form prints each checkout's better time per kernel and the ratio of
the second label over the first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

NX, NVAR, SEED = 96, 7, 0
GATHER_BP = 512
BF16 = "bfloat16"
FULL = {k: BF16 for k in ("src_dtype", "meta_dtype", "grad_dtype",
                          "halo_dtype")}
K6_CELLS = ((4, 8.0), (4, 32.0))
K6_SMALL = 0.125
# K6, K3-peer, K2 and K3's gather instances (their mangled names)
PTXAS_KERNELS = ("overlap_peer", "push_phases", "sweep_gather", "GatherSrc")
GATHER_MODELS = (("", 1, {}), ("", 8, {}),
                 ("_w16_o16", 1, {"meta_dtype": BF16, "grad_dtype": BF16}),
                 ("_w16_o16", 8, {"meta_dtype": BF16, "grad_dtype": BF16}),
                 ("_flux", 8, {"op": "flux"}))


def ptxas_facts(log: str) -> dict:
    """{entry: [registers, spill store bytes]} of the K6, K3-peer and
    gather instances in a ptxas report."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1) if any(k in m.group(1)
                                     for k in PTXAS_KERNELS) else None
        elif name and (m := re.search(r"(\d+) bytes spill stores", ln)):
            out.setdefault(name, [None, None])[1] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(name, [None, None])[0] = int(m.group(1))
    return out


def measure(root: str) -> dict:
    """{kernel: ms} and the ptxas facts of the checkout at root."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
    from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
    from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
    from cfd_proxy_tpu_torch.ops import _cuda
    from cfd_proxy_tpu_torch.ops import blocksweep as bs
    from cfd_proxy_tpu_torch.ops import push
    from cfd_proxy_tpu_torch.parallel.transport import Peer
    from cfd_proxy_tpu_torch.tools import icibench

    if not torch.cuda.is_available():
        raise SystemExit("chip_turns: needs a CUDA card")
    dev = torch.device("cuda", 0)
    facts = ptxas_facts(_cuda.build()["log"])
    ms = {}
    gmesh = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=SEED)
    gvar = make_state(gmesh.npoint, NVAR, seed=SEED + 1)

    # K4, f32 and bf16d, as the model's table rebuild launches it
    parts1 = partition_mesh(gmesh, 1)
    for name, opts in (("pack_srcs", {}), ("pack_srcs_d16",
                                           {"src_dtype": BF16})):
        m1 = GreenGaussTorch(parts1, NVAR, device=dev, **opts)
        var_T = m1.distribute_state(gvar, schedules=["bulk"])["var_T"]
        before = bs.pack_srcs.launches + bs.pack_srcs.d16_launches
        ms[name] = cs.cuda_ms(lambda: m1._build_tables(var_T, ["bulk"]), 50)
        if bs.pack_srcs.launches + bs.pack_srcs.d16_launches == before:
            raise SystemExit(f"chip_turns: {name} was not launched")
        del m1, var_T

    # K6 at one rank (self-sends), 24 rows
    def k6(nph, mb):
        lanes = icibench.payload_lanes(mb, 24)
        peer = icibench.make_transport(1, nph, 24, lanes, dev, None)
        send = torch.randn((1, nph, 24, lanes), device=dev,
                           generator=torch.Generator(dev).manual_seed(nph))
        return peer, send

    for nph, mb in K6_CELLS:
        peer, send = k6(nph, mb)
        ms[f"push_phases_full_{nph}x{mb}MB"] = cs.kernel_device_ms(
            lambda: push.push_phases(send, peer, "full"), 20)
        peer.close()
    peer, send = k6(1, K6_SMALL)
    for m in push.MODES:
        ms[f"push_phases_{m}_1x{K6_SMALL}MB"] = cs.kernel_device_ms(
            lambda m=m: push.push_phases(send, peer, m), 100)
    peer.close()
    del peer, send

    # K3's peer form at the 8-shard interior + push shapes
    parts8 = partition_mesh(gmesh, 8)
    for name, opts, wire in (
            ("sweep_blocks_overlap_peer", {}, torch.float32),
            ("sweep_blocks_overlap_gather_peer",
             {"kernel": "gather", "bp": GATHER_BP}, torch.float32),
            ("sweep_blocks_overlap_peer_w16_d16_o16", FULL, torch.bfloat16)):
        m8 = GreenGaussTorch(parts8, NVAR, device=dev, **opts)
        st = m8.distribute_state(gvar, schedules=["overlap", "bulk"])
        iargs = (st["var_T"], *m8._operands("interior", st["tables"]))
        gb = m8.step(st, "nocomm")
        sendbufs = m8._pack(gb, m8.pack_scale, wire)
        peer = Peer(m8.dsts.numpy(), m8.srcs.numpy(), rows=m8.rows,
                    s_max=m8.s_max, dtype=wire, device=dev)
        fused = (bs.sweep_blocks_overlap_gather if m8.kernel == "gather"
                 else bs.sweep_blocks_overlap)
        # the gather model's keyword operand, in a tree that has one
        kw = (m8._gather_kw("interior") if hasattr(m8, "_gather_kw")
              else {})
        buf = gb.clone()
        ms[name] = cs.cuda_ms(
            lambda: fused(*iargs, buf, sendbufs, None, None, peer=peer,
                          **kw), 50)
        peer.close()
        del m8, st, iargs, gb, sendbufs, peer, buf
    # the gather sweep at bp 512, as the model calls it (its output's zero
    # fill included where it has one); K3-gather in both forms
    for tag, npart, opts in GATHER_MODELS:
        m = GreenGaussTorch(parts1 if npart == 1 else parts8, NVAR,
                            kernel="gather", bp=GATHER_BP, device=dev,
                            **opts)
        st = m.distribute_state(gvar, schedules=["overlap", "bulk"])
        var_T, tbs = st["var_T"], st["tables"]
        ms[f"sweep_blocks_gather{tag}_P{npart}"] = cs.cuda_ms(
            lambda: m._sweep("bulk", var_T, tbs), 50)
        if npart == 1:
            del m, st, var_T, tbs
            continue
        gb = m.step(st, "nocomm")
        buf = gb.clone()
        ms[f"sweep_blocks_gather_init{tag}_P{npart}"] = cs.cuda_ms(
            lambda: m._sweep("interior", var_T, tbs, init=buf), 50)
        # the keyword operand of a tree whose model has one
        kw = m._gather_kw("interior") if hasattr(m, "_gather_kw") else {}
        iargs = (var_T, *m._operands("interior", tbs))
        sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
        fused = bs.sweep_blocks_overlap_gather
        ms[f"sweep_blocks_overlap_gather{tag}_P{npart}"] = cs.cuda_ms(
            lambda: fused(*iargs, buf, sendbufs, m.dsts, m.srcs, op=m.op,
                          **kw), 50)
        del m, st, var_T, tbs, gb, buf, iargs, sendbufs
    bad = [k for k, v in ms.items() if not np.isfinite(v)]
    if bad:
        raise SystemExit(f"chip_turns: no finite time for {bad}")
    return {"ms": ms, "ptxas": facts}


def summary(path: str) -> dict:
    """Each label's better time per kernel, and the second label's over the
    first's, from the JSON lines of `path` (in the order they were run)."""
    runs = [json.loads(ln) for ln in open(path) if ln.strip()]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    best = {lb: {} for lb in labels}
    for r in runs:
        for k, v in r["ms"].items():
            got = best[r["label"]]
            got[k] = min(got.get(k, v), v)
    out = {"labels": labels, "runs": len(runs), "ms": best}
    if len(labels) == 2:
        a, b = labels
        out[f"{b}_over_{a}"] = {k: best[b][k] / best[a][k]
                                for k in best[a] if k in best[b]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose port is timed")
    ap.add_argument("--label", default="", help="name of this run's tree")
    ap.add_argument("--summary", help="JSON lines of earlier runs")
    a = ap.parse_args(argv)
    if a.summary:
        print(json.dumps(summary(a.summary)))
        return 0
    if not a.root:
        ap.error("--root or --summary")
    print(json.dumps({"label": a.label or a.root, "root": a.root,
                      **measure(a.root)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
