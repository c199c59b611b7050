"""Offline mesh partitioner + comm-list construction.

The reference consumes meshes pre-partitioned offline (the proxy only reads;
SURVEY.md §1) and builds per-neighbor send/recv lists at startup
(`setup_comm.c`, SURVEY.md §4.4).  This module is both: a recursive
coordinate-bisection (RCB) partitioner — geometry-based, the standard choice
for CFD meshes, handles any partition count — plus the exact `setup_comm`
semantics: ghost closure by depth, owned-first local numbering, and paired
send/recv index lists whose buffer order matches on both sides.

Layout contract produced here (consumed by mesh/model.py and parallel/):
- local points = [owned (sorted by global id) | ghosts by (depth, owner, gid)]
- faces kept = faces incident to ≥1 point of depth < ghost_layers, i.e. every
  face needed to compute gradients at owned points (depth-0) and, with deeper
  halos, at shallow ghosts too;
- comm entry (A↔B, round r): A.sendidx = A-owned points that are depth-(r+1)
  ghosts at B, sorted by global id; B.recvidx = B's slots of those ghosts,
  same sort → position-matched buffers (reference: paired sendidx/recvidx).

The port's copy of `cfd_proxy_tpu/mesh/partition.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

import numpy as np

from cfd_proxy_tpu_torch.mesh.generator import GlobalMesh
from cfd_proxy_tpu_torch.mesh.model import CommEntry, MeshPartition
from cfd_proxy_tpu_torch.utils.errors import check


def rcb_assign(coords: np.ndarray, npart: int) -> np.ndarray:
    """Recursive coordinate bisection: returns owner partition per point.

    Splits along the widest axis at the weighted fraction, so any npart works
    (not just powers of two) with balanced part sizes (±1 point).  Runs in
    native C++ when available (same membership for tie-free coordinates;
    both paths break coordinate ties deterministically, by different rules).
    """
    N = coords.shape[0]
    check(0 < npart <= N,
          "npart %d must be in [1, npoint=%d] (every partition needs at "
          "least one point)", npart, N)
    from cfd_proxy_tpu_torch.native import rcb_assign_c

    native = rcb_assign_c(coords, npart)
    if native is not None:
        return native
    owner = np.zeros(N, dtype=np.int32)

    def rec(idx: np.ndarray, lo: int, hi: int) -> None:
        nparts = hi - lo
        if nparts == 1:
            owner[idx] = lo
            return
        n1 = nparts // 2
        c = coords[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        k = (idx.size * n1) // nparts
        vals = c[:, axis]
        if 0 < k < idx.size:
            # O(N) selection: same left/right membership as a tie-broken
            # sort whenever the cut value is unique; ties (e.g. jitter=0
            # grids) fall back to a sort whose tie-break is the GLOBAL
            # point id (lexsort), so membership never depends on the
            # layout argpartition happened to hand an ancestor cut —
            # argpartition's order around k is unspecified and can change
            # across numpy versions.  The tie probe compares the LEFT
            # partition's max (argpartition only guarantees position k)
            ord_ = np.argpartition(vals, k)
            if vals[ord_[:k]].max() == vals[ord_[k]]:
                ord_ = np.lexsort((idx, vals))
        else:
            ord_ = np.lexsort((idx, vals))
        rec(idx[ord_[:k]], lo, lo + n1)
        rec(idx[ord_[k:]], lo + n1, hi)

    rec(np.arange(N), 0, npart)
    return owner


def _ghost_closure_numpy(faces, owner, npart, K):
    """Sparse per-partition ghost closure — NumPy fallback path.

    Returns (ghost_gid, ghost_depth, goff, face_ids, foff), the same sparse
    protocol as the native fast path (native/partition.cc): per partition
    the ghost (gid, depth) pairs and the kept-face ids ascending, with
    prefix offsets.  O(npart·K·F) — the native path replaces exactly this.
    """
    N = owner.shape[0]
    fa, fb = faces[:, 0], faces[:, 1]
    gg, gd, fi = [], [], []
    goff = np.zeros(npart + 1, np.int64)
    foff = np.zeros(npart + 1, np.int64)
    for p in range(npart):
        depth = np.full(N, -1, dtype=np.int8)
        depth[owner == p] = 0
        for d in range(1, K + 1):
            frontier = depth == d - 1
            mark = np.zeros(N, dtype=bool)
            mark[fb[frontier[fa]]] = True
            mark[fa[frontier[fb]]] = True
            depth[mark & (depth == -1)] = d
        g = np.flatnonzero(depth > 0)
        gg.append(g.astype(np.int32))
        gd.append(depth[g])
        keep = (depth[fa] >= 0) & (depth[fa] < K)
        keep |= (depth[fb] >= 0) & (depth[fb] < K)
        fi.append(np.flatnonzero(keep).astype(np.int32))
        goff[p + 1] = goff[p] + g.size
        foff[p + 1] = foff[p] + fi[-1].size
    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    return cat(gg, np.int32), cat(gd, np.int8), goff, cat(fi, np.int32), foff


def partition_mesh(
    mesh: GlobalMesh,
    npart: int,
    *,
    ghost_layers: int = 1,
    owner: np.ndarray | None = None,
) -> list[MeshPartition]:
    """Partition a GlobalMesh into npart MeshPartitions with K-deep ghosts.

    The ghost closure runs in native C++ when available (native/partition.cc
    — CSR + stamped BFS, O(halo) per partition instead of O(K·F)); the NumPy
    fallback is semantics-identical and parity-tested."""
    check(npart >= 1, "npart must be >= 1")
    check(ghost_layers >= 1, "ghost_layers must be >= 1")
    N = mesh.npoint
    faces = mesh.faces
    fa, fb = faces[:, 0], faces[:, 1]
    if owner is None:
        owner = rcb_assign(mesh.coords, npart)
    check(owner.shape == (N,), "owner shape")
    owner = np.ascontiguousarray(owner, np.int32)

    from cfd_proxy_tpu_torch.native import ghost_closure_c

    sparse = ghost_closure_c(faces, owner, npart, ghost_layers)
    if sparse is None:
        sparse = _ghost_closure_numpy(faces, owner, npart, ghost_layers)
    ghost_gid, ghost_depth, goff, face_ids, foff = sparse

    # owned point lists: one stable sort instead of npart full scans
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(npart + 1))
    owned_gids_of = [np.sort(order[bounds[p] : bounds[p + 1]])
                     for p in range(npart)]

    # send map: (src_owner p, dst q, depth d) -> gids sorted — read straight
    # off each q's ghost list (those ARE p's send points), no global scans
    send_map: dict[tuple[int, int, int], np.ndarray] = {}
    for q in range(npart):
        g = ghost_gid[goff[q] : goff[q + 1]]
        d = ghost_depth[goff[q] : goff[q + 1]]
        ow = owner[g]
        for key in np.unique(ow * (ghost_layers + 1) + d):
            p, dd = int(key) // (ghost_layers + 1), int(key) % (ghost_layers + 1)
            send_map[(p, q, dd)] = np.sort(g[(ow == p) & (d == dd)])

    parts: list[MeshPartition] = []
    g2l = np.full(N, -1, dtype=np.int64)   # reused across partitions: full-N
    for p in range(npart):                 # memsets were the profile hotspot
        owned_gids = owned_gids_of[p]
        nowned = owned_gids.size
        g = ghost_gid[goff[p] : goff[p + 1]].astype(np.int64)
        gdep = ghost_depth[goff[p] : goff[p + 1]]
        # ghosts ordered by (depth, owner, gid) — the layout contract
        ord_ = np.lexsort((g, owner[g], gdep))
        g, gdep = g[ord_], gdep[ord_]
        l2g = np.concatenate([owned_gids, g])
        g2l[l2g] = np.arange(l2g.size)

        fsel = face_ids[foff[p] : foff[p + 1]]
        pf = np.stack([g2l[fa[fsel]], g2l[fb[fsel]]], axis=1)
        check(int(pf.min(initial=0)) >= 0, "face endpoint outside ghost closure")
        pn = mesh.normals[fsel].copy()
        swap = pf[:, 0] > pf[:, 1]
        pf[swap] = pf[swap][:, ::-1]
        pn[swap] = -pn[swap]

        comm: list[CommEntry] = []
        for d in range(1, ghost_layers + 1):
            sel_d = gdep == d
            g_d, own_d = g[sel_d], owner[g[sel_d]]
            for q in range(npart):
                if q == p:
                    continue
                recv_g = np.sort(g_d[own_d == q])
                send_g = send_map.get((p, q, d), np.zeros(0, np.int64))
                if recv_g.size == 0 and send_g.size == 0:
                    continue
                sendidx = np.searchsorted(owned_gids, send_g)
                recvidx = g2l[recv_g]
                comm.append(CommEntry(
                    partner=q,
                    round=d - 1,
                    sendidx=sendidx.astype(np.int32),
                    recvidx=recvidx.astype(np.int32),
                ))

        part = MeshPartition(
            part_id=p,
            npart=npart,
            nowned=int(nowned),
            coords=mesh.coords[l2g],
            global_ids=l2g.astype(np.int32),
            faces=pf.astype(np.int32),
            normals=pn,
            volume=mesh.volume[l2g],
            comm=comm,
        )
        part.validate()
        parts.append(part)
        g2l[l2g] = -1          # sparse reset — only touched entries
    return parts


def relabel_owned(part: MeshPartition, new_of_old: np.ndarray) -> MeshPartition:
    """Renumber OWNED points by a permutation (ghost numbering unchanged).

    Used to apply a locality ordering (RCB) so that VMEM-block-sized ranges of
    owned points are geometrically compact — the TPU analogue of the cache-
    blocking the reference gets from its per-thread rangelist face sort
    (SURVEY.md §2 L3).  Ghost ordering is preserved because recvidx ranges
    must stay contiguous per comm entry (contiguous unpack on device).
    """
    nowned = part.nowned
    check(new_of_old.shape == (nowned,), "perm must cover owned points")
    full = np.arange(part.npoint)
    full[:nowned] = new_of_old
    old_of_new = np.empty(part.npoint, dtype=np.int64)
    old_of_new[full] = np.arange(part.npoint)

    faces = full[part.faces]
    normals = part.normals.copy()
    swap = faces[:, 0] > faces[:, 1]
    faces[swap] = faces[swap][:, ::-1]
    normals[swap] = -normals[swap]

    comm = [
        CommEntry(
            partner=e.partner,
            round=e.round,
            sendidx=full[e.sendidx].astype(np.int32),
            recvidx=e.recvidx.copy(),      # ghosts unchanged
        )
        for e in part.comm
    ]
    out = MeshPartition(
        part_id=part.part_id,
        npart=part.npart,
        nowned=nowned,
        coords=part.coords[old_of_new],
        global_ids=part.global_ids[old_of_new],
        faces=faces.astype(np.int32),
        normals=normals,
        volume=part.volume[old_of_new],
        comm=comm,
    )
    out.validate()
    return out


def degree_sort_order(deg: np.ndarray, block: int,
                      base_order: np.ndarray | None = None,
                      freeze_prefix: int = 0) -> np.ndarray:
    """In-block degree sort shared by the model relabel and kbench's plans.

    Stable-sorts the positions of `base_order` (default: identity) by
    DESCENDING degree within each `block`-sized chunk — block membership is
    untouched, only in-block lane order moves, so per-block ext lists are
    unchanged while the compact prefix widths (ops/blocksweep.py::
    prefix_widths) become tight.  Returns new_of_old ids.  Kept in ONE place
    because the compact layout's correctness-tightness story depends on the
    sort key; kbench must measure the exact layout the model builds.

    freeze_prefix: leave the first N positions UNSORTED (the comm region —
    its signature-group runs must stay contiguous for the segmented pack;
    rcb_owned_order).  Implemented as a per-position key override so block
    membership stays positional."""
    n = deg.shape[0]
    order = np.arange(n) if base_order is None else base_order
    pos_blk = np.arange(n) // block        # device-block index by POSITION
    sort_deg = -deg[order].astype(np.int64)
    if freeze_prefix > 0:
        # frozen positions sort FIRST within their block (stable → original
        # relative order); being a prefix, they already occupy the block's
        # leading positions, so they stay exactly in place
        sort_deg[:freeze_prefix] = np.int64(-(2**62))
    key = np.lexsort((np.arange(n), sort_deg, pos_blk))
    order = order[key]
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order] = np.arange(n)
    return new_of_old


def rcb_owned_order(part: MeshPartition, *, block: int = 256,
                    degree_sort: bool = False,
                    comm_first: bool = True,
                    entry_phase: np.ndarray | None = None) -> np.ndarray:
    """RCB-based locality permutation for the owned points (new id of old).

    degree_sort=True additionally stable-sorts points by incidence count
    (descending) WITHIN each `block`-sized chunk of the RCB order.  Block
    membership — and therefore every per-block ext list — is unchanged; only
    the in-block lane order moves, concentrating high-degree points in the
    leading 128-lane tiles.  This is what makes the compact packed layout's
    static prefix widths tight (ops/blocksweep.py::prefix_widths): the ~21%
    inert padding slots of a valence-skewed mesh drop out of the two
    dominant kernel streams.  (The round-2 alternative — a global
    degree-class relabel — exploded ext lists ~5× and was reverted;
    in-block sorting cannot, by construction.)

    comm_first=True (default) places the SEND points — the halo-adjacent set
    every exchange packs — at the FRONT of the order, RCB-sorted within both
    regions.  The pack gather then reads from a small static window [0, W_c)
    instead of the whole (rows, ndev) array: XLA's column gather measured
    1.6 ns/col from a VMEM-sized table vs 3-5 ns/col from the full array,
    and the window is uniform across shards (SPMD-clean).  At P=1 there are
    no sends, so this is the identity and the single-chip headline is
    untouched.  Comm-region blocks lose a little in-block RCB locality for
    their ext lists; sends are a few percent of points.

    Within the comm region, points are grouped by their SIGNATURE — the set
    of comm entries (partner, round) that send them — each group a
    contiguous ascending column run (RCB-sorted within).  Every phase's
    send list is then a concatenation of whole groups, so the device pack
    can be a handful of static-length dynamic slices instead of a gather
    (tlayout's segmented lane layout; BASELINE.md round-4).  The in-block
    degree sort skips the comm region — reordering inside a block would
    break the groups' contiguity (the region is a few percent of points;
    the compact-prefix loss there is noise).

    entry_phase (round 5): phase id per comm entry (aligned with
    part.comm).  When given, signatures are keyed by the PHASE set and
    groups are ordered by the CANONICAL (len, tuple) phase-signature order
    — the same order build_tlayout enumerates signatures in — so that
    consecutive groups sharing a phase form column-ADJACENT runs and
    tlayout can merge them into INTERVAL slices (one dynamic_slice covering
    several whole groups; eliminates the small-group gather tail and its
    ~0.85/0.55 µs fixed costs, BASELINE.md round 5).  Without it the group
    order is the np.unique lexicographic order of entry membership —
    per-shard, so cross-group adjacency is not canonical and tlayout packs
    per group."""
    nowned = part.nowned
    nblk = max(1, nowned // block)
    blk = rcb_assign(part.coords[:nowned], nblk)
    order = np.argsort(blk, kind="stable")     # old ids in new order
    ncomm = 0
    if comm_first:
        sp = send_point_set(part)
        if sp.size:
            # signature id per send point: which comm entries send it.
            # Exact for any entry count: a (send points, entries) membership
            # matrix keyed through np.unique(axis=0) — send points are a few
            # percent of a shard and entries a few dozen, so the matrix is
            # tiny.  (A single int64 bitmask caps at 62 entries, which K=3
            # closures at 64+ shards exceed.)
            pos_of = np.full(nowned, -1, dtype=np.int64)
            pos_of[sp] = np.arange(sp.size)
            if entry_phase is not None:
                check(len(entry_phase) == len(part.comm),
                      "entry_phase length %d != comm entries %d",
                      len(entry_phase), len(part.comm))
                nph = int(max(entry_phase, default=-1)) + 1
                memb = np.zeros((sp.size, max(nph, 1)), dtype=bool)
                for i, e in enumerate(part.comm):
                    memb[pos_of[e.sendidx], int(entry_phase[i])] = True
                rows, sig_of_sp = np.unique(memb, axis=0,
                                            return_inverse=True)
                # canonical group order: (len, phase tuple) — matches
                # build_tlayout's signature enumeration
                keys = [tuple(np.flatnonzero(r)) for r in rows]
                rank_of = {i: r for r, i in enumerate(sorted(
                    range(len(keys)), key=lambda i: (len(keys[i]), keys[i])))}
                sig_of_sp = np.array([rank_of[int(s)] for s in sig_of_sp])
            else:
                memb = np.zeros((sp.size, len(part.comm)), dtype=bool)
                for i, e in enumerate(part.comm):
                    memb[pos_of[e.sendidx], i] = True
                _, sig_of_sp = np.unique(memb, axis=0, return_inverse=True)
            sig = np.full(nowned, -1, dtype=np.int64)
            sig[sp] = sig_of_sp
            is_send = sig >= 0
            sel = is_send[order]
            comm = order[sel]
            # group by signature (stable: RCB order preserved within)
            comm = comm[np.argsort(sig[comm], kind="stable")]
            order = np.concatenate([comm, order[~sel]])
            ncomm = comm.size
    if degree_sort:
        deg = np.bincount(part.faces.ravel(), minlength=part.npoint)[:nowned]
        return degree_sort_order(deg, block, base_order=order,
                                 freeze_prefix=ncomm)
    new_of_old = np.empty(nowned, dtype=np.int64)
    new_of_old[order] = np.arange(nowned)
    return new_of_old


def send_point_set(part: MeshPartition) -> np.ndarray:
    """Owned points referenced by any sendidx — the halo-adjacent set whose
    gradients must be final before the exchange can fire (the reference's
    finish-counter targets; SURVEY.md §4.3)."""
    if not part.comm:
        return np.zeros(0, dtype=np.int32)
    idx = np.concatenate([e.sendidx for e in part.comm])
    return np.unique(idx).astype(np.int32)


def exchange_host(parts: list[MeshPartition], arrays: list[np.ndarray]) -> None:
    """Host-side reference halo exchange (in place), all rounds in order.

    The NumPy golden analogue of the exchange layer: round r scatters each
    partner's packed send buffer into ghost slots.  Used by tests as the
    correctness model for the device-side ppermute exchange.

    Arrays must be writable — note `np.asarray(jax_array)` returns a
    READ-ONLY view; pass `np.array(x)` copies when mixing with device results.
    """
    for a in arrays:
        check(a.flags.writeable,
              "exchange_host mutates in place; got a read-only array "
              "(np.asarray of a jax array? use np.array(x) to copy)")
    nrounds = max((pt.nrounds for pt in parts), default=0)
    for r in range(nrounds):
        packed: dict[tuple[int, int], np.ndarray] = {}
        for pt in parts:
            for e in pt.comm:
                if e.round == r and e.sendidx.size:
                    packed[(pt.part_id, e.partner)] = arrays[pt.part_id][e.sendidx]
        for pt in parts:
            for e in pt.comm:
                if e.round == r and e.recvidx.size:
                    arrays[pt.part_id][e.recvidx] = packed[(e.partner, pt.part_id)]
