"""Kernel times of one checkout of the port at the smoke run's shapes, for
comparing two commits' source pack, push path and gather sweep on one card.

    python3 chip_turns.py --root DIR --label NAME [--rows k4,kbench,...]
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
K2's cluster instances on the one-shard plans with force_rdma at bp 4096
and 8192 (K2_CLUSTER: gg, flux and bf16 weights and stores, the bulk plan
zero-filled and the interior plan with init), each also back to back
on the card (`_held`: `chip_smoke.kernel_device_ms`);
K2 on the one-shard bulk plan at bp 512, at the AUTO block size (4096)
and at bp 8192 under the body the rule picks (in a tree with the cluster
body also that body forced at each of its block sizes, 256 and 512
threads, and the staged and cluster bodies forced on the edge plans
EDGES: the one-shard plan at bp 512 and 2048 with its ext columns spread
over a wider table, just under and just over GATHER_STAGE_PAIR, where the
rule turns from staged to cluster); K3-gather as the overlap step calls
it at one shard (force_rdma) and two, at bp 4096 (AUTO) and 8192
(K3_SHAPES), gg f32, w16-o16 (bf16 weights, stores and halo) and flux,
loopback and through a one-process peer transport, under the rule's body
and under each body the tree's fused kernel has (FUSED_GATHER_BODIES
where the tree names them apart, else GATHER_BODIES) whose table fits
one block there, forced, and the overlap step
at each shape under the solver's dispatch; every K2 and K3-gather instance
of the two-shard plans at bp 8192 (`quad`: K2 bulk, K2-init on the
boundary and interior plans, K3-gather loopback and peer; gg f32,
w16-o16 and flux) under the rule's body, also back to back, with each
call's bound and its body's facts, and in a tree with the quad body the
one-shard bp 8192 plan under the quad and cluster bodies forced and the
two-shard gg plans at 256 and 512 quad threads; the direct body
(`direct`), forced where the rule picks another: K2 bulk, K2-init on the
boundary (from zeros) and interior plans and K3-gather loopback and peer
at the two-shard bp 8192 plans, flux and gg (beside `quad`'s rows: the
rule's evidence), K2 bulk and K3-gather on the
one-shard bp 8192 gg plan (force_rdma), K3-gather-flux at the eight-shard
interior + push shapes at bp 512, and K2 on the one-shard bp 8192 bulk
plan widened past 29 000 columns (`edge_plan`, EP DIRECT_EDGE_EP) and cut
to a bp that is not a multiple of 4 (`odd_plan`, DIRECT_ODD_BP), each
with its bound and the instance's facts, and in a tree whose direct body
has two source layouts (a plan's `sources`, `blocksweep.direct_sources`)
each layout forced; the main path's step and its glue (`main`): the
boundary sweep zero-filled as the tree runs it and on a zero fill with
init, at one shard (force_rdma, AUTO bp) and eight (bp 1024), packed and
gather/512, K1 zero-filled on the one-shard bulk plan, the chained update
as two torch operations and, in a tree that has it, as ops.update's
kernel, and the one-shard bulk, early and overlap and eight-shard bulk
steps under the solver's dispatch (`time_schedule`);
kbench's rows on its 96³ prefix
tables (bp 4096): K5d (compact_i8), K1-w16-d16-o16 (compact_bso) and
K5e-bf16 (cstream_bso); a hash of each gather and kbench output, which shows two
trees' outputs equal bit for bit; and ptxas's registers and spill bytes of
every K6, K3-peer, gather, kbench rung, K1 and update instance.  `--rows` times only
the named groups of ROWS.  The mesh is the smoke run's (96³, seed 0, nvar 7).  Times are
CUDA-event means of 50 calls (`chip_smoke.cuda_ms`), K6 back to back on the
card (`chip_smoke.kernel_device_ms`), both from DIR's `chip_smoke.py`.  Run
it on the two checkouts in turns (A, B, B, A), appending to one file; the
second form prints each checkout's better time per kernel, the ratio of
the second label over the first and, per output hash, whether the two
trees agree.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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
# K6, K3-peer, K2 and K3's gather instances, kbench's rungs, K1 and the
# chained update (their mangled names)
PTXAS_KERNELS = ("overlap_peer", "push_phases", "sweep_gather", "GatherSrc",
                 "rung_kernel", "i8_kernel", "sweep_packed", "chain_update")
AUTO_BP, LARGE_BP = 4096, 8192     # the AUTO block size at one shard; 2x
KB_BP = 4096                       # kbench's block size
KB_ROWS = ("compact_i8", "compact_bso", "cstream_bso")
# the row groups: K4, K6, K3-peer, the gather sweep at bp 512, K2 at bp 512,
# 4096 and 8192, K2's cluster instances, K3-gather at bp 4096 and 8192,
# every instance of the two-shard plans at bp 8192 (the quad body's),
# the direct body's plans, the main path's step and glue, kbench's rows
ROWS = ("k4", "k6", "peer", "gather", "bodies", "cluster", "k3large",
        "quad", "direct", "main", "kbench")
# the main path's group: its models (tag, shards, options; one shard with
# force_rdma), the update's coupling (the reference's) and the timed steps
MAIN_MODELS = (("p1", 1, {}), ("p8", 8, {}),
               ("gather512_p1", 1, {"kernel": "gather", "bp": GATHER_BP}),
               ("gather512_p8", 8, {"kernel": "gather", "bp": GATHER_BP}))
MAIN_COUPLING = 1e-30
MAIN_STEPS = 200
# the direct body's edge plans: the one-shard bp 8192 bulk plan with its
# ext table widened to 24 576 columns (32 768 in all, past the quarter
# table a block holds: the rule's direct body for every op), and cut to bp
# 8190 (not a multiple of 4)
DIRECT_EDGE_EP = 24576
DIRECT_ODD_BP = 8190
# K3-gather at large block sizes: its shapes (shards, bp; one shard with
# force_rdma) and configurations (tag, model options)
K3_SHAPES = ((1, AUTO_BP), (1, LARGE_BP), (2, AUTO_BP), (2, LARGE_BP))
K3_LARGE = (("", {}),
            ("_w16_o16", {"meta_dtype": BF16, "grad_dtype": BF16,
                          "halo_dtype": BF16}),
            ("_flux", {"op": "flux"}))
# K2's cluster instances: the one-shard plans (force_rdma) at bp 4096 and
# 8192, gg f32, flux and bf16 weights and stores (tag, model options)
K2_CLUSTER = (("", {}), ("_flux", {"op": "flux"}),
              ("_w16_o16", {"meta_dtype": BF16, "grad_dtype": BF16}))
# (bp, EP) of the edge plans: 3 584 table columns (114 688 B staged, under
# GATHER_STAGE_PAIR's 115 456) and 3 712 (118 784 B, over it) at bp 512,
# 3 712 at bp 2048
EDGES = ((512, 3072), (512, 3200), (2048, 1664))
GATHER_MODELS = (("", 1, {}), ("", 8, {}),
                 ("_w16_o16", 1, {"meta_dtype": BF16, "grad_dtype": BF16}),
                 ("_w16_o16", 8, {"meta_dtype": BF16, "grad_dtype": BF16}),
                 ("_flux", 8, {"op": "flux"}))


def digest(t) -> str:
    """A hash of a tensor's bytes: equal hashes, equal outputs bit for
    bit."""
    import torch

    raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def edge_plan(args: tuple, kw: dict, ep: int) -> tuple:
    """K2's operands `args` (var_T, exts, slot_idx, ...) of a real plan,
    its ext table widened to `ep` columns: every ext W-index j spread to
    j·ep // EP (the own lanes and each lane's slot pattern kept), every
    entry's ext count ep, the new columns drawn from a seeded normal.  The
    staged and cluster bodies then stage bp + ep columns an entry."""
    import torch

    var_T, exts, sidx, *rest = args
    P, nb, nv, ep0 = exts.shape
    bp = rest[1].shape[-1]
    ext = sidx >= bp
    wide = torch.where(ext, bp + (sidx - bp) * ep // ep0, sidx)
    gen = torch.Generator(exts.device).manual_seed(SEED)
    exts = torch.randn((P, nb, nv, ep), generator=gen, device=exts.device)
    cnt = torch.full_like(kw["ext_cnt"], ep)
    return (var_T, exts, wide.to(sidx.dtype), *rest), {"ext_cnt": cnt}


def odd_plan(args: tuple, kw: dict, bp: int) -> tuple:
    """K2's operands `args` of a real plan cut to block size `bp` (below
    the plan's): the state and the output to the first ndev // bp·bp
    columns, every table to its first bp lanes, the slot widths capped at
    bp; an own W-index past the cut moved two columns down, an ext one
    kept on its ext column.  Returns (args, kw, columns of the output)."""
    var_T, exts, sidx, slot_w, scale, block_ids, slots = args
    bp0 = scale.shape[-1]
    ndev = var_T.shape[-1] // bp * bp
    assert int(block_ids.max()) < ndev // bp
    cut = sidx[..., :bp]
    cut = (cut.where(cut < bp, cut - (bp0 - bp)))
    widths = slots.clone()
    widths[0] = widths[0].clamp(max=bp)
    return ((var_T[..., :ndev].contiguous(), exts, cut.contiguous(),
             slot_w[..., :bp].contiguous(), scale[..., :bp].contiguous(),
             block_ids, widths), dict(kw), ndev)


def plan_sources(bs, args: tuple, kw: dict) -> dict:
    """kw with the direct body's sources that a model of module bs chooses
    where it loads the plan `args` (var_T, exts, slot_idx, slot_w, scale,
    block_ids, slots): `blocksweep.direct_sources` on its lanes per table
    column; kw as it is in a tree without that choice."""
    if not hasattr(bs, "direct_sources"):
        return kw
    exts, slot_w, scale, block_ids, slots = (args[1], *args[3:])
    lanes = bs.table_lanes_per_column(slot_w, block_ids, slots[0].tolist(),
                                      kw["ext_cnt"])
    return {**kw, "sources": bs.direct_sources(scale.shape[-1],
                                               exts.shape[-1], lanes)}


@contextlib.contextmanager
def sources_forced(m, kw: dict, mode):
    """The direct body's sources `mode` ("table" or "columns"; None: each
    plan's own) in model m's choices per class and the gather keywords kw
    while the block runs."""
    if mode is None:
        yield
        return
    held = dict(m.sources), kw.get("sources")
    m.sources.update(dict.fromkeys(m.sources, mode))
    kw["sources"] = mode
    try:
        yield
    finally:
        m.sources.update(held[0])
        kw["sources"] = held[1]


def demangled(names: list) -> list:
    """C++ symbols as c++filt prints them (the names as they are where it
    is missing): an anonymous namespace's mangled name differs from one
    build of a source to the next, its demangled one does not."""
    import subprocess

    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return names
    out = res.stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_facts(log: str) -> dict:
    """{entry: [registers, spill store bytes]} of the K6, K3-peer and
    gather instances in a ptxas report, by demangled name."""
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
    return dict(zip(demangled(list(out)), out.values()))


def measure(root: str, rows=ROWS) -> dict:
    """{kernel: ms}, output hashes and the ptxas facts of the checkout at
    root, for the row groups `rows` (ROWS)."""
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
    from cfd_proxy_tpu_torch.solver import time_schedule
    from cfd_proxy_tpu_torch.tools import icibench

    if not torch.cuda.is_available():
        raise SystemExit("chip_turns: needs a CUDA card")
    dev = torch.device("cuda", 0)
    facts = ptxas_facts(_cuda.build()["log"])
    ms = {}
    gmesh = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=SEED)
    gvar = make_state(gmesh.npoint, NVAR, seed=SEED + 1)

    parts1, parts8 = partition_mesh(gmesh, 1), partition_mesh(gmesh, 8)
    hashes, rule = {}, {}
    if "k4" in rows:
        # K4, f32 and bf16d, as the model's table rebuild launches it
        for name, opts in (("pack_srcs", {}), ("pack_srcs_d16",
                                               {"src_dtype": BF16})):
            m1 = GreenGaussTorch(parts1, NVAR, device=dev, **opts)
            var_T = m1.distribute_state(gvar, schedules=["bulk"])["var_T"]
            before = bs.pack_srcs.launches + bs.pack_srcs.d16_launches
            ms[name] = cs.cuda_ms(
                lambda: m1._build_tables(var_T, ["bulk"]), 50)
            if bs.pack_srcs.launches + bs.pack_srcs.d16_launches == before:
                raise SystemExit(f"chip_turns: {name} was not launched")
            del m1, var_T

    if "k6" in rows:
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

    if "peer" in rows:
        # K3's peer form at the 8-shard interior + push shapes
        for name, opts, wire in (
                ("sweep_blocks_overlap_peer", {}, torch.float32),
                ("sweep_blocks_overlap_gather_peer",
                 {"kernel": "gather", "bp": GATHER_BP}, torch.float32),
                ("sweep_blocks_overlap_peer_w16_d16_o16", FULL,
                 torch.bfloat16)):
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
    if "gather" in rows:
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
            hashes[f"sweep_blocks_gather{tag}_P{npart}"] = digest(
                m._sweep("bulk", var_T, tbs))
            if npart == 1:
                del m, st, var_T, tbs
                continue
            gb = m.step(st, "nocomm")
            buf = gb.clone()
            ms[f"sweep_blocks_gather_init{tag}_P{npart}"] = cs.cuda_ms(
                lambda: m._sweep("interior", var_T, tbs, init=buf), 50)
            hashes[f"sweep_blocks_gather_init{tag}_P{npart}"] = digest(
                m._sweep("interior", var_T, tbs, init=gb.clone()))
            # the keyword operand of a tree whose model has one
            kw = m._gather_kw("interior") if hasattr(m, "_gather_kw") else {}
            iargs = (var_T, *m._operands("interior", tbs))
            sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
            fused = bs.sweep_blocks_overlap_gather
            ms[f"sweep_blocks_overlap_gather{tag}_P{npart}"] = cs.cuda_ms(
                lambda: fused(*iargs, buf, sendbufs, m.dsts, m.srcs, op=m.op,
                              **kw), 50)
            del m, st, var_T, tbs, gb, buf, iargs, sendbufs

    if "bodies" in rows:
        # K2 on the one-shard bulk plan at bp 512, the AUTO block size and
        # bp 8192, under the rule's body, and (a tree that has it) the
        # cluster body forced at each of its block sizes; then the staged
        # and cluster bodies on the edge plans
        bodies = getattr(bs, "GATHER_BODIES", ())
        for bp in (GATHER_BP, AUTO_BP, LARGE_BP):
            m = GreenGaussTorch(parts1, NVAR, kernel="gather", bp=bp,
                                device=dev)
            st = m.distribute_state(gvar, schedules=["bulk"])
            var_T, tbs = st["var_T"], st["tables"]
            ep = int(m.plans["bulk"]["ext_idx"].shape[2])
            runs = {f"sweep_blocks_gather_bp{bp}": (bs.gather_body(bp, ep),
                                                    None)}
            if "cluster" in bodies:
                runs.update({f"sweep_blocks_gather_bp{bp}_cluster{n}":
                             ("cluster", n) for n in (256, 512)})
            for key, (body, threads) in runs.items():
                with cs.gather_body_forced(bs, body):
                    rule_threads = getattr(bs, "cluster_threads", None)
                    if threads is not None:
                        bs.cluster_threads = lambda *_, n=threads: n
                    ms[key] = cs.cuda_ms(lambda: m._sweep("bulk", var_T, tbs),
                                         50)
                    hashes[key] = digest(m._sweep("bulk", var_T, tbs))
                    if threads is not None:
                        bs.cluster_threads = rule_threads
            rule[f"bp{bp}"] = {"ep": ep, "body": bs.gather_body(bp, ep)}
            del m, st, var_T, tbs
        for bp in dict.fromkeys(b for b, _ in EDGES) if "cluster" in bodies \
                else ():
            m = GreenGaussTorch(parts1, NVAR, kernel="gather", bp=bp,
                                device=dev)
            st = m.distribute_state(gvar, schedules=["bulk"])
            real = (st["var_T"], *m._operands("bulk", st["tables"]))
            for ep in (e for b, e in EDGES if b == bp):
                args, kw = edge_plan(real, m._gather_kw("bulk"), ep)
                key = f"sweep_blocks_gather_edge_bp{bp}_ep{ep}"
                rule[key] = {"columns": bp + ep,
                             "staged_bytes": bs.staged_bytes(bp, ep),
                             "body": bs.gather_body(bp, ep)}
                for body in ("staged", "cluster"):
                    with cs.gather_body_forced(bs, body):
                        ms[f"{key}_{body}"] = cs.cuda_ms(
                            lambda: bs.sweep_blocks_gather(*args, **kw), 50)
                        hashes[f"{key}_{body}"] = digest(
                            bs.sweep_blocks_gather(*args, **kw))
                del args, kw
            del m, st, real

    if "cluster" in rows:
        # K2 on the one-shard bulk plan (zero-filled) and interior plan
        # (init) at bp 4096 and 8192, as the model's steps call it
        for bp in (AUTO_BP, LARGE_BP):
            for tag, opts in K2_CLUSTER:
                m = GreenGaussTorch(parts1, NVAR, kernel="gather", bp=bp,
                                    device=dev, force_rdma=True, **opts)
                st = m.distribute_state(gvar, schedules=["overlap", "bulk"])
                var_T, tbs = st["var_T"], st["tables"]
                gb = m.step(st, "bulk")
                buf = gb.clone()
                calls = {
                    f"k2{tag}_bp{bp}": lambda: m._sweep("bulk", var_T, tbs),
                    f"k2{tag}_init_bp{bp}": lambda: m._sweep(
                        "interior", var_T, tbs, init=buf)}
                for key, fn in calls.items():
                    # as the smoke times it, and back to back on the card
                    ms[key] = cs.cuda_ms(fn, 50)
                    ms[key + "_held"] = cs.kernel_device_ms(fn, 50)
                hashes[f"k2{tag}_bp{bp}"] = digest(
                    m._sweep("bulk", var_T, tbs))
                hashes[f"k2{tag}_init_bp{bp}"] = digest(
                    m._sweep("interior", var_T, tbs, init=gb.clone()))
                for cls in ("bulk", "interior"):
                    ep = int(m.plans[cls]["ext_idx"].shape[2])
                    rule[f"k2{tag}_{cls}_bp{bp}"] = {
                        "ep": ep, "body": bs.gather_body(bp, ep, m.op)}
                m.close()
                del m, st, var_T, tbs, gb, buf

    if "k3large" in rows:
        # K3-gather at the interior + push shapes of one shard (force_rdma)
        # and two at bp 4096 and 8192, as the overlap step calls it,
        # loopback and peer
        parts2 = partition_mesh(gmesh, 2)
        fused_bodies = getattr(bs, "FUSED_GATHER_BODIES", bs.GATHER_BODIES)
        fits = {"staged": bs.staged_bytes, "direct": lambda *_: 0,
                "cluster": lambda b, e: bs.staged_bytes(b, e) // 2,
                "quad": lambda b, e: bs.staged_bytes(b, e) // 4}
        for npart, bp in K3_SHAPES:
            for tag, opts in K3_LARGE:
                m = GreenGaussTorch(parts1 if npart == 1 else parts2, NVAR,
                                    kernel="gather", bp=bp, device=dev,
                                    force_rdma=npart == 1, **opts)
                st = m.distribute_state(gvar, schedules=["overlap", "bulk"])
                iargs = (st["var_T"], *m._operands("interior", st["tables"]))
                kw = {"op": m.op, **m._gather_kw("interior")}
                gb = m.step(st, "bulk")
                sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
                ep = int(m.plans["interior"]["ext_idx"].shape[2])
                shape = f"P{npart}_bp{bp}"
                rule[f"k3g{tag}_{shape}"] = {
                    "ep": ep, "body": bs.gather_body(bp, ep, m.op, True)}
                # the bodies whose table (or half of it) fits one block
                runs = {"": None}
                for body in fused_bodies:
                    if fits[body](bp, ep) <= bs.GATHER_STAGE_MAX:
                        runs[f"_{body}"] = body
                peer = Peer(m.dsts.numpy(), m.srcs.numpy(), rows=m.rows,
                            s_max=m.s_max, dtype=m.halo_t, device=dev)
                for form, push in (("", (m.dsts, m.srcs, {})),
                                   ("_peer", (None, None, {"peer": peer}))):
                    d, s_, how = push
                    for suffix, body in runs.items():
                        key = f"k3g{tag}{form}_{shape}{suffix}"
                        buf = gb.clone()

                        def call(i):
                            return bs.sweep_blocks_overlap_gather(
                                *iargs, i, sendbufs, d, s_, **kw, **how)

                        with (cs.gather_body_forced(bs, body) if body
                              else contextlib.nullcontext()):
                            ms[key] = cs.cuda_ms(lambda: call(buf), 50)
                            g, r = call(gb.clone())
                            hashes[key] = digest(g) + digest(r)
                peer.close()
                if not tag:
                    # the overlap step itself, under the solver's dispatch
                    # (graph on the card)
                    ms[f"step_{shape}_overlap"] = time_schedule(
                        m, st, "overlap", 200, warmup=2,
                        repeats=5).median * 1e3
                del m, st, iargs, gb, sendbufs, peer, buf, g, r

    if "quad" in rows:
        # every K2 and K3-gather instance of the two-shard plans at bp 8192
        # as the model's steps call them (K2 on the bulk plan, K2-init on
        # the boundary plan from zeros and on the interior plan, K3-gather
        # loopback and peer), under the rule's body (the quad body in a tree
        # that has it, else direct), also back to back on the card
        # (`_held`), each with its bound and its body's facts; the overlap
        # step under the solver's dispatch.  In a tree with the quad body,
        # also the one-shard bp 8192 plan (force_rdma) under the quad body
        # forced beside the cluster body, and the two-shard gg plans at 256
        # and 512 quad threads
        parts2 = partition_mesh(gmesh, 2)
        quad = "quad" in getattr(bs, "GATHER_BODIES", ())
        bounds = {}
        for tag, opts in K3_LARGE:
            m = GreenGaussTorch(parts2, NVAR, kernel="gather", bp=LARGE_BP,
                                device=dev, **opts)
            st = m.distribute_state(gvar, schedules=["overlap", "bulk"])
            var_T, tbs = st["var_T"], st["tables"]
            gb = m.step(st, "bulk")
            sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
            iargs = (var_T, *m._operands("interior", tbs))
            kw = {"op": m.op, **m._gather_kw("interior")}
            peer = Peer(m.dsts.numpy(), m.srcs.numpy(), rows=m.rows,
                        s_max=m.s_max, dtype=m.halo_t, device=dev)
            # key: (call on an init buffer, the init, class, fused, peer)
            calls = {
                f"q_k2{tag}_bulk": (
                    lambda i: m._sweep("bulk", var_T, tbs), None, "bulk",
                    False, False),
                f"q_k2{tag}_init_boundary": (
                    lambda i: m._sweep("boundary", var_T, tbs, init=i),
                    torch.zeros_like(gb), "boundary", False, False),
                f"q_k2{tag}_init_interior": (
                    lambda i: m._sweep("interior", var_T, tbs, init=i), gb,
                    "interior", False, False),
                f"q_k3g{tag}": (
                    lambda i: bs.sweep_blocks_overlap_gather(
                        *iargs, i, sendbufs, m.dsts, m.srcs, **kw), gb,
                    "interior", True, False),
                f"q_k3g{tag}_peer": (
                    lambda i: bs.sweep_blocks_overlap_gather(
                        *iargs, i, sendbufs, None, None, peer=peer, **kw),
                    gb, "interior", True, True)}
            threads = {"": None}
            if quad and not tag:
                threads.update({f"_t{n}": n for n in (256, 512)})
            for key, (fn, init, cls, fused, is_peer) in calls.items():
                buf = None if init is None else init.clone()
                for suffix, n in threads.items():
                    rule_threads = getattr(bs, "quad_threads", None)
                    if n is not None:
                        bs.quad_threads = lambda *_, n=n: n
                    ms[key + suffix] = cs.cuda_ms(lambda: fn(buf), 50)
                    if n is None:
                        ms[key + "_held"] = cs.kernel_device_ms(
                            lambda: fn(buf), 50)
                    out = fn(None if init is None else init.clone())
                    hashes[key + suffix] = "".join(
                        digest(o) for o in (out if fused else (out,)))
                    if n is not None:
                        bs.quad_threads = rule_threads
                args = (var_T, *m._operands(cls, tbs))
                bounds[key] = cs.sweep_bound(
                    m.op, args, gather=True, init=init is not None,
                    push=sendbufs if fused else None,
                    out_bytes=gb.element_size())["bound_ms"]
                ep = int(m.plans[cls]["ext_idx"].shape[2])
                body = bs.gather_body(LARGE_BP, ep, m.op, fused)
                rule[key] = {"ep": ep, "body": body,
                             "kernel": cs.gather_kernel_facts(
                                 bs, body, LARGE_BP, ep, m.op, m.w_t,
                                 m.grad_t, fused, is_peer)}
                del buf
            peer.close()
            if not tag:
                ms["q_step_P2_bp8192_overlap"] = time_schedule(
                    m, st, "overlap", 200, warmup=2, repeats=5).median * 1e3
            m.close()
            del m, st, var_T, tbs, gb, sendbufs, iargs, peer, calls, out
        for tag, opts in K3_LARGE if quad else ():
            m = GreenGaussTorch(parts1, NVAR, kernel="gather", bp=LARGE_BP,
                                device=dev, force_rdma=True, **opts)
            st = m.distribute_state(gvar, schedules=["overlap", "bulk"])
            var_T, tbs = st["var_T"], st["tables"]
            gb = m.step(st, "bulk")
            sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
            iargs = (var_T, *m._operands("interior", tbs))
            kw = {"op": m.op, **m._gather_kw("interior")}
            calls = {
                f"q1_k2{tag}_bulk": (
                    lambda i: m._sweep("bulk", var_T, tbs), None, False),
                f"q1_k2{tag}_init_interior": (
                    lambda i: m._sweep("interior", var_T, tbs, init=i), gb,
                    False),
                f"q1_k3g{tag}": (
                    lambda i: bs.sweep_blocks_overlap_gather(
                        *iargs, i, sendbufs, m.dsts, m.srcs, **kw), gb,
                    True)}
            for key, (fn, init, fused) in calls.items():
                buf = None if init is None else init.clone()
                for body in ("cluster", "quad"):
                    with cs.gather_body_forced(bs, body):
                        ms[f"{key}_{body}"] = cs.cuda_ms(lambda: fn(buf), 50)
                        ms[f"{key}_{body}_held"] = cs.kernel_device_ms(
                            lambda: fn(buf), 50)
                        out = fn(None if init is None else init.clone())
                    hashes[f"{key}_{body}"] = "".join(
                        digest(o) for o in (out if fused else (out,)))
                del buf
            m.close()
            del m, st, var_T, tbs, gb, sendbufs, iargs, calls, out
        rule["q_bound_ms"] = bounds

    if "direct" in rows:
        # the direct body, forced, under each source layout the tree has
        modes = {"": None}
        if hasattr(bs, "direct_sources"):
            modes.update({f"_{m}": m for m in ("table", "columns")})
        bounds = {}

        def direct_rows(key, fn, init, fused, args, m, kw, cols=None):
            """Time fn(init buffer) under the direct body in each layout
            (the tree's own also back to back on the card, `_held`), and
            the table build alone (`_tbl`), hash its output (the first
            `cols` columns), record its bound, its plan's real slot lanes
            per table column and the instance's facts."""
            for suffix, mode in modes.items():
                buf = None if init is None else init.clone()
                with cs.gather_body_forced(bs, "direct"), \
                        sources_forced(m, kw, mode):
                    ms[key + suffix] = cs.cuda_ms(lambda: fn(buf), 50)
                    if mode is None:        # back to back on the card
                        ms[key + "_held"] = cs.kernel_device_ms(
                            lambda: fn(buf), 50)
                    out = fn(None if init is None else init.clone())
                outs = out if fused else (out,)
                hashes[key + suffix] = "".join(
                    digest(o if o.dim() < 3 or cols is None
                           else o[..., :cols]) for o in outs)
                del buf, out, outs
            w_bytes = 2 if m.grad_t == torch.bfloat16 else 4
            bounds[key] = cs.sweep_bound(
                m.op, args, gather=True, init=init is not None,
                push=fn.push if fused else None, out_bytes=w_bytes)
            bp_ = int(args[-3].shape[-1])
            ep = int(args[1].shape[-1])
            rule[key] = {"ep": ep, "bp": bp_,
                         "rule_body": bs.gather_body(bp_, ep, m.op, fused),
                         "kernel": cs.gather_kernel_facts(
                             bs, "direct", bp_, ep, m.op, m.w_t, m.grad_t,
                             fused, fn.peer)}
            if hasattr(bs, "gather_table"):
                cnt = kw.get("ext_cnt")
                ms[key + "_tbl"] = cs.cuda_ms(lambda: bs.gather_table(
                    args[0], args[1], args[5], bp_, ext_cnt=cnt), 50)
                bounds[key] = cs.table_bound(bs, bounds[key], args, kw)
                rule[key].update(
                    sources=kw.get("sources"),
                    lanes_per_column=bs.table_lanes_per_column(
                        args[3], args[5], args[6][0].tolist(),
                        cnt if cnt is not None else torch.full_like(
                            args[5], ep)))

        def call(f, push=None, peer=False):
            f.push, f.peer = push, peer
            return f

        parts2 = partition_mesh(gmesh, 2)
        for npart, bp, opts in ((2, LARGE_BP, {"op": "flux"}),
                                (2, LARGE_BP, {}),
                                (1, LARGE_BP, {"force_rdma": True}),
                                (8, GATHER_BP, {"op": "flux"})):
            m = GreenGaussTorch({1: parts1, 2: parts2, 8: parts8}[npart],
                                NVAR, kernel="gather", bp=bp, device=dev,
                                **opts)
            st = m.distribute_state(gvar, schedules=["overlap", "bulk"])
            var_T, tbs = st["var_T"], st["tables"]
            gb = m.step(st, "bulk")
            sendbufs = m._pack(gb, m.pack_scale, m.halo_t)
            iargs = (var_T, *m._operands("interior", tbs))
            # the plan's keywords read at call time (`sources_forced`)
            kw = {"op": m.op}
            shape = f"{m.op}_P{npart}_bp{bp}"
            calls = {
                "k2_bulk": (call(lambda i: m._sweep("bulk", var_T, tbs)),
                            None, "bulk", False),
                "k2_init_boundary": (
                    call(lambda i: m._sweep("boundary", var_T, tbs, init=i)),
                    torch.zeros_like(gb), "boundary", False),
                "k2_init_interior": (
                    call(lambda i: m._sweep("interior", var_T, tbs, init=i)),
                    gb, "interior", False),
                "k3g": (call(lambda i: bs.sweep_blocks_overlap_gather(
                    *iargs, i, sendbufs, m.dsts, m.srcs, **kw,
                    **m._gather_kw("interior")), sendbufs),
                    gb, "interior", True)}
            if npart == 2:
                peer = Peer(m.dsts.numpy(), m.srcs.numpy(), rows=m.rows,
                            s_max=m.s_max, dtype=m.halo_t, device=dev)
                calls["k3g_peer"] = (call(
                    lambda i: bs.sweep_blocks_overlap_gather(
                        *iargs, i, sendbufs, None, None, peer=peer, **kw,
                        **m._gather_kw("interior")),
                    sendbufs, True), gb, "interior", True)
            else:
                peer = None
                keep = ("k2_bulk", "k3g") if npart == 1 else ("k3g",)
                calls = {k: v for k, v in calls.items() if k in keep}
            for name, (fn, init, cls, fused) in calls.items():
                direct_rows(f"d_{name}_{shape}", fn, init, fused,
                            (var_T, *m._operands(cls, tbs)), m,
                            m._gather_kw(cls))
            if peer is not None:
                peer.close()
            if npart == 1:
                # K2 on the bulk plan widened past a quarter table a block
                # holds, and cut to a bp that is not a multiple of 4
                real = (var_T, *m._operands("bulk", tbs))
                args, ekw = edge_plan(real, m._gather_kw("bulk"),
                                      DIRECT_EDGE_EP)
                ekw = plan_sources(bs, args, ekw)
                direct_rows(f"d_k2_edge_ep{DIRECT_EDGE_EP}_{shape}",
                            call(lambda i: bs.sweep_blocks_gather(
                                *args, **ekw)), None, False, args, m, ekw)
                args, okw, cols = odd_plan(real, m._gather_kw("bulk"),
                                           DIRECT_ODD_BP)
                okw = plan_sources(bs, args, okw)
                direct_rows(f"d_k2_bp{DIRECT_ODD_BP}_P1",
                            call(lambda i: bs.sweep_blocks_gather(
                                *args, **okw)), None, False, args, m, okw,
                            cols=cols)
                del real, args, ekw, okw
            m.close()
            del m, st, var_T, tbs, gb, sendbufs, iargs, calls, peer
        rule["d_bound"] = bounds

    if "main" in rows:
        # the main path's step and its glue: the boundary sweep both ways,
        # zero-filled as the tree's wrapper runs it (its own zeros, or a
        # fill before it) and its init form on a zero fill, at P=1 `all`
        # (force_rdma, AUTO bp: bench.py's main row) and P=8 (bp 1024),
        # packed and gather/512 (cuda_ms and back to back, `_held`); K1
        # zero-filled on the P=1 bulk plan; the update on the P=1 bulk
        # step's state and gradients, as two torch operations (the parent's
        # chained body) and, in a tree that has it, as ops.update's kernel;
        # then the P=1 bulk, early and overlap and P=8 bulk steps under the
        # solver's dispatch (graph on the card), the solver's two-point
        # median of MAIN_STEPS-step loops
        try:
            from cfd_proxy_tpu_torch.ops import update
        except ImportError:
            update = None
        for tag, npart, opts in MAIN_MODELS:
            m = GreenGaussTorch(parts1 if npart == 1 else parts8, NVAR,
                                device=dev, force_rdma=npart == 1, **opts)
            st = m.distribute_state(gvar)
            var_T, tbs = st["var_T"], st["tables"]
            sweep = (bs.sweep_blocks_gather if m.kernel == "gather"
                     else bs.sweep_blocks)
            kw = (m._gather_kw("boundary") if m.kernel == "gather" else {})
            bargs = (var_T, *m._operands("boundary", tbs))
            zeros = torch.zeros((m.nlocal, m.rows, m.ndev), device=dev)
            calls = {
                "boundary_zero_filled": lambda: sweep(*bargs, **kw),
                "boundary_fill_init": lambda: sweep(
                    *bargs, init=torch.zeros_like(zeros), **kw)}
            for name, fn in calls.items():
                key = f"{name}_{tag}"
                ms[key] = cs.cuda_ms(fn, 50)
                ms[key + "_held"] = cs.kernel_device_ms(fn, 50)
                hashes[key] = digest(fn())
            rule[f"boundary_{tag}"] = {
                "bp": m.bp, "blocks": m.ndev // m.bp,
                "listed": [len(set(r.tolist())) for r in
                           m.plans["boundary"]["block_ids"].cpu()]}
            if tag == "p1":
                args = (var_T, *m._operands("bulk", tbs))
                ms["k1_bulk_p1"] = cs.cuda_ms(lambda: bs.sweep_blocks(*args),
                                              50)
                ms["k1_bulk_p1_held"] = cs.kernel_device_ms(
                    lambda: bs.sweep_blocks(*args), 50)
                g = bs.sweep_blocks(*args)
                buf = torch.empty_like(var_T)
                upd = {"update_two_op": lambda: torch.add(
                    var_T, MAIN_COUPLING * g[:, :var_T.shape[1]], out=buf)}
                if update is not None:
                    upd["update_kernel"] = lambda: update.chain_update(
                        var_T, g, MAIN_COUPLING, out=buf)
                for name, fn in upd.items():
                    ms[name] = cs.cuda_ms(fn, 50)
                    ms[name + "_held"] = cs.kernel_device_ms(fn, 50)
                del args, g, buf, upd
            if m.kernel == "packed":
                for s_ in (("bulk", "early", "overlap") if npart == 1
                           else ("bulk",)):
                    ms[f"step_{s_}_{tag}"] = time_schedule(
                        m, st, s_, MAIN_STEPS, warmup=2,
                        repeats=5).median * 1e3
                    # the eager step's device parts: ms a launch, launches
                    prof = cs.device_profile(m, st, s_, graph=False,
                                             detail=True)
                    rule[f"parts_{s_}_{tag}"] = {
                        k: [prof["kernels"][k][1] / prof["kernels"][k][0]
                            / 1e3, n]
                        for k, n in prof["launches"].items()}
            m.close()
            del m, st, var_T, tbs, bargs, zeros, calls

    if "kbench" in rows:
        # kbench's rows on its 96³ prefix tables
        from cfd_proxy_tpu_torch.tools import kbench

        benches = kbench.make_benches(gmesh, bp=KB_BP, device=dev)
        table = kbench.variant_table(benches, list(KB_ROWS))
        for name in KB_ROWS:
            fn, v, t = table[name]
            ms[name] = cs.cuda_ms(lambda: fn(v, t), 50)
            hashes[name] = digest(fn(v, t))
        del benches, table
    bad = [k for k, v in ms.items() if not np.isfinite(v)]
    if bad:
        raise SystemExit(f"chip_turns: no finite time for {bad}")
    return {"ms": ms, "hash": hashes, "gather_rule": rule, "ptxas": facts}


def summary(path: str) -> dict:
    """Each label's better time per kernel, and the second label's over the
    first's, from the JSON lines of `path` (in the order they were run)."""
    runs = [json.loads(ln) for ln in open(path) if ln.strip()]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    best = {lb: {} for lb in labels}
    hashes = {lb: {} for lb in labels}
    for r in runs:
        got = best[r["label"]]
        for k, v in r["ms"].items():
            got[k] = min(got.get(k, v), v)
        for k, h in r.get("hash", {}).items():
            hashes[r["label"]].setdefault(k, set()).add(h)
    out = {"labels": labels, "runs": len(runs), "ms": best}
    if len(labels) == 2:
        a, b = labels
        out[f"{b}_over_{a}"] = {k: best[b][k] / best[a][k]
                                for k in best[a] if k in best[b]}
        out["equal_bitwise"] = {k: hashes[a][k] == hashes[b][k]
                                and len(hashes[a][k]) == 1
                                for k in hashes[a] if k in hashes[b]}
        # ptxas: the instances both trees build whose registers or spills
        # differ, and those one tree alone builds
        pa, pb = ({k: v for r in runs if r["label"] == lb
                   for k, v in r.get("ptxas", {}).items()} for lb in (a, b))
        common = set(pa) & set(pb)
        out["ptxas"] = {"common": len(common),
                        "changed": {k: [pa[k], pb[k]] for k in sorted(common)
                                    if pa[k] != pb[k]},
                        f"only_{a}": {k: pa[k]
                                      for k in sorted(set(pa) - common)},
                        f"only_{b}": {k: pb[k]
                                      for k in sorted(set(pb) - common)}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose port is timed")
    ap.add_argument("--label", default="", help="name of this run's tree")
    ap.add_argument("--summary", help="JSON lines of earlier runs")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="row groups to time, of " + ",".join(ROWS))
    a = ap.parse_args(argv)
    if a.summary:
        print(json.dumps(summary(a.summary)))
        return 0
    if not a.root:
        ap.error("--root or --summary")
    print(json.dumps({"label": a.label or a.root, "root": a.root,
                      **measure(a.root, a.rows.split(","))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
