"""Transposed device layout: point-column mapping + halo regions.

NumPy copy of `cfd_proxy_tpu/parallel/tlayout.py` (the port imports
nothing of the JAX package).  The code is the original's line for line, so
`ndev`, `locmap` and `owned_pad` are identical and the port's outputs compare
column for column with the reference's; tests/test_torch_plan.py holds the
two equal.

Device state layout (per shard, uniform across shards):

    [ owned cols 0..nowned | pad to owned_pad | phase-0 ghost region (s_max) |
      phase-1 ghost region (s_max) | ... | pad to multiple of bp ]

Every comm entry is one edge of one exchange phase (parallel/topology.py),
and each phase owns a RESERVED s_max-column ghost region at a STATIC offset —
so halo unpack is one contiguous store per phase at a fixed position, on
every device, with padding lanes landing in reserved trash columns.  Pack is
a column gather, transfer is one buffer per phase, unpack a contiguous store.

Ghost column positions mirror the SENDER's pack order (position-matched
buffers), so no index translation happens at runtime at all.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy_tpu_torch.mesh.model import MeshPartition
from cfd_proxy_tpu_torch.utils import round_up
from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.parallel.topology import HaloTopology

LANE = 128

# A segmented phase packs as one contiguous slice per SLICE segment plus one
# small gather over the TAIL region.  Only segments this long earn a slice,
# and at most SEG_MAX_PER_PHASE of them — the rest join the tail.
SEG_MIN_LANES = 64
SEG_MAX_PER_PHASE = 8


@dataclass
class TLayout:
    """Host-side transposed device layout for P shards."""

    bp: int
    owned_pad: int
    s_max: int
    nphases: int
    ndev: int
    perms: list            # perms[k] = tuple of (src, dst) pairs (static)
    locmap: list           # per part: (npoint,) local id -> device column
    send_idx: np.ndarray   # (P, nphases, s_max) i32 device columns, pad 0
    send_mask: np.ndarray  # (P, nphases, s_max) f32 1.0 on real lanes, 0 pad
    dsts: np.ndarray       # (P, nphases) i32 — destination device per phase;
                           # devices idle in a phase SELF-send (the phase
                           # matching is completed to a permutation so every
                           # device participates uniformly)
    srcs: np.ndarray       # (P, nphases) i32 — source device per phase
    # (nphases,) bool — phase crosses slice (node) boundaries; padded
    # self-send phases are False.  Required (no default).
    inter_slice: np.ndarray
    # per-phase SEGMENTED lane layout, or None per phase when unavailable:
    # seg_offs[k] = ((lane_off, L), ...) — static, identical across shards.
    # Lane [off, off+L) of phase k holds one signature group's send pairs
    # (a contiguous ascending column run on every shard, by the comm-first
    # grouped relabel), so the pack is a concat of static-length slices
    # instead of a gather.  None for a phase ⇒ prefix-packed lanes.
    #
    # Only segments >= SEG_MIN_LANES long (at most SEG_MAX_PER_PHASE, big
    # first) get slices; the remaining small segments form the phase's TAIL
    # — tail_offs[k] = (lane_off, L) or None — packed by ONE gather of those
    # lanes' columns.  Lane layout per phase: slice segments first
    # (descending length), then the tail.
    seg_offs: tuple = ()
    tail_offs: tuple = ()

    @property
    def ghost_start(self) -> int:
        return self.owned_pad


def build_tlayout(
    parts: list[MeshPartition], topo: HaloTopology, *, bp: int = 256,
    min_phases: int = 1, fake_sends: int = 0, seg_slack: float = 1.25,
    fake_tail_frac: float = 0.0,
) -> TLayout:
    """min_phases: pad the schedule with extra self-send phases (each is a
    full self-permutation of masked zeros) — exercises multi-phase exchange
    machinery on a single device, where the natural phase count is 1.

    fake_sends: BENCHMARK-ONLY — give each PADDED phase a real payload: the
    first min(fake_sends, nowned) owned columns in a shuffled order, mask 1,
    self-permutation.  The self-send lands in the phase's reserved ghost
    region, which no face references, so owned results are unchanged — but
    pack/transfer/unpack move REAL multi-phase payloads on a single device.

    fake_tail_frac: BENCHMARK-ONLY, with fake_sends — the trailing fraction
    of each fake phase's lanes becomes a GATHER TAIL (strided non-contiguous
    columns, tail_offs set) instead of slice segments, reproducing the mixed
    slices+tail layout of a real multi-shard topology.

    seg_slack: lane-width budget for the SEGMENTED layout, as a multiple of
    the prefix-packed phase width.  A phase's segmented width is
    Σ_sig max-over-shards group size — tail pads that ride the wire and
    widen every ghost region.  Phases whose segmented width exceeds
    seg_slack × the prefix-packed s_max fall back to prefix-packed lanes +
    gather pack, per phase."""
    P = len(parts)
    # positional identity, mirrored from build_halo_topology: locmap,
    # send_idx rows and ph.recv_idx are all indexed by position
    for i, pt in enumerate(parts):
        check(pt.part_id == i,
              "parts out of order: index %d holds part_id %d", i, pt.part_id)
    owned_pad = round_up(max(p.nowned for p in parts), bp)
    nphases = max(topo.nphases, 1, int(min_phases))

    # ---- signature analysis for the SEGMENTED lane layout ----
    # Active pair lists per (shard, phase): send columns ascending (the
    # topology pair sort), recv ghost ids aligned positionally.
    act: dict[tuple[int, int], tuple] = {}
    for k, ph in enumerate(topo.phases):
        for (src, dst) in ph.perm:
            cnt = int((ph.recv_idx[dst] < topo.npoint_pad).sum())
            act[(src, k)] = (ph.send_idx[src, :cnt].astype(np.int64),
                             ph.recv_idx[dst, :cnt].astype(np.int64))
    # per-shard signature (set of phases) of every send column
    sig_cols: list[dict] = [dict() for _ in range(P)]   # sig -> cols list
    col_sig: list[dict] = [dict() for _ in range(P)]
    for p in range(P):
        phase_of: dict[int, list] = {}
        for k in range(topo.nphases):
            si_ri = act.get((p, k))
            if si_ri is None:
                continue
            for c in si_ri[0]:
                phase_of.setdefault(int(c), []).append(k)
        for c, ks in phase_of.items():
            sig = tuple(ks)         # ascending (k loop order)
            col_sig[p][c] = sig
            sig_cols[p].setdefault(sig, []).append(c)
    sigs = sorted({s for d in sig_cols for s in d},
                  key=lambda s: (len(s), s))
    # segmented layout requires every (shard, signature) group to be one
    # contiguous ascending column run — the comm-first grouped relabel
    # guarantees it; un-relabeled callers fall back to prefix-packed lanes
    segmented = bool(sigs)
    for sig in sigs:
        for p in range(P):
            cols = np.sort(np.asarray(sig_cols[p].get(sig, ()), np.int64))
            if cols.size > 1 and not (np.diff(cols) == 1).all():
                segmented = False
    # INTERVAL detection: when the relabel laid each shard's comm region
    # group-after-group in the CANONICAL sig order (rcb_owned_order with
    # entry_phase), consecutive sigs' runs are column-adjacent on every
    # shard — so a phase can cover a run of consecutive sigs that all
    # contain it with ONE slice (an interval), instead of one slice per
    # group + a gather tail for the tiny ones.
    aligned = segmented
    if segmented:
        for p in range(P):
            runs = [np.sort(np.asarray(sig_cols[p][s], np.int64))
                    for s in sigs if sig_cols[p].get(s)]
            if runs:
                cat = np.concatenate(runs)
                if cat.size > 1 and not (np.diff(cat) == 1).all():
                    aligned = False
                    break
    # per-phase lane plan over UNITS (interval = tuple of consecutive sigs
    # when aligned; singleton groups otherwise), in DESCENDING length
    # order; the leading >= SEG_MIN_LANES units (at most SEG_MAX_PER_PHASE)
    # become slice segments, everything after them is the gather TAIL
    phase_order: list[list] = []   # per phase: units (tuples of sigs)
    phase_lens: list[list] = []    # per phase: unit max-over-shards lengths
    phase_segs: list[tuple] = []   # per phase: ((off, L), ...) slices
    phase_tail: list = []          # per phase: (off, L) or None
    if segmented:
        for k in range(topo.nphases):
            if aligned:
                units, cur = [], []
                for s in sigs:
                    if k in s:
                        cur.append(s)
                    elif cur:
                        units.append(tuple(cur))
                        cur = []
                if cur:
                    units.append(tuple(cur))
            else:
                units = [(s,) for s in sigs if k in s]
            lens = []
            for u in units:
                n_max = 0
                for p in range(P):
                    n_max = max(n_max, sum(len(sig_cols[p].get(s, ()))
                                           for s in u))
                lens.append(n_max)
            order = sorted(range(len(units)),
                           key=lambda i: (-lens[i], units[i]))
            units = [units[i] for i in order]
            lens = [lens[i] for i in order]
            offs, off = [], 0
            # aligned intervals: ANY unit length earns a slice;
            # SEG_MAX_PER_PHASE still caps fragmented topologies (units
            # beyond the cap tail).
            min_lanes = 1 if aligned else SEG_MIN_LANES
            for L in lens:
                if L < min_lanes or len(offs) >= SEG_MAX_PER_PHASE:
                    break
                offs.append((off, L))
                off += L
            width = sum(lens)
            tail = (off, width - off) if width > off else None
            phase_order.append(units)
            phase_lens.append(lens)
            phase_segs.append(tuple(offs))
            phase_tail.append(tail)
    # per-phase width gating (see seg_slack in the docstring): segmented
    # tail pads ride the wire and widen every ghost region, so a phase
    # keeps the segmented lanes only while its width fits the slack-capped
    # prefix-packed budget; others fall back to prefix-packed lanes
    w_legacy = max(topo.max_phase_size(), 1)
    use_segs = [False] * topo.nphases
    if segmented and phase_order:
        budget = max(float(seg_slack) * w_legacy, float(LANE))
        use_segs = [sum(phase_lens[k]) <= budget
                    for k in range(topo.nphases)]
    smax_req = 1
    for k in range(topo.nphases):
        smax_req = max(smax_req, sum(phase_lens[k])
                       if use_segs[k] else w_legacy)
    if topo.nphases == 0:
        smax_req = w_legacy
    # fake phases (benchmark-only): contiguous-run segments so the fake
    # measurement exercises the production segs pack path
    n_fake = 0
    if fake_sends > 0 and nphases > topo.nphases:
        n_fake = int(fake_sends)
        check(n_fake <= min(p.nowned for p in parts),
              "fake_sends %d exceeds the smallest shard (%d owned)",
              n_fake, min(p.nowned for p in parts))
        smax_req = max(smax_req, n_fake)
    s_max = round_up(smax_req, LANE)
    # +bp: a dedicated trailing TRASH block that no real point maps to — the
    # safe target for padded grid entries
    ndev = round_up(owned_pad + nphases * s_max, bp) + bp

    locmap = []
    for p in parts:
        lm = np.full(p.npoint, -1, dtype=np.int64)
        lm[: p.nowned] = np.arange(p.nowned)
        locmap.append(lm)

    inter_slice = np.zeros(nphases, dtype=bool)
    send_idx = np.zeros((P, nphases, s_max), dtype=np.int32)
    send_mask = np.zeros((P, nphases, s_max), dtype=np.float32)
    dsts = np.full((P, nphases), -1, dtype=np.int32)
    srcs = np.full((P, nphases), -1, dtype=np.int32)
    perms = []
    seg_offs: list = []
    tail_offs: list = []
    for k, ph in enumerate(topo.phases):
        perms.append(tuple(ph.perm))
        inter_slice[k] = bool(ph.inter_slice)
        if use_segs[k]:
            # SEGMENTED lanes: each UNIT (interval of consecutive sigs, or
            # a single group) at its static offset (slice segments first,
            # descending length, then the tail units); per-unit tail pads
            # repeat the unit's last column (send, mask 0) and stay OOB on
            # the recv side
            seg_offs.append(phase_segs[k])
            tail_offs.append(phase_tail[k])
            for (src, dst) in ph.perm:
                si, ri = act[(src, k)]
                lanes_recv = np.full(s_max, topo.npoint_pad, np.int64)
                off = 0
                for u, L in zip(phase_order[k], phase_lens[k]):
                    parts_u = [np.asarray(sig_cols[src][s], np.int64)
                               for s in u if sig_cols[src].get(s)]
                    cols = (np.sort(np.concatenate(parts_u)) if parts_u
                            else np.zeros(0, np.int64))
                    n = cols.size
                    if n:
                        pos = np.searchsorted(si, cols)
                        send_idx[src, k, off:off + n] = cols
                        send_mask[src, k, off:off + n] = 1.0
                        lanes_recv[off:off + n] = ri[pos]
                        if n < L:
                            send_idx[src, k, off + n:off + L] = cols[-1]
                    off += L
                valid = np.flatnonzero(lanes_recv < topo.npoint_pad)
                locmap[dst][lanes_recv[valid]] = (owned_pad + k * s_max
                                                  + valid)
                dsts[src, k] = dst
                srcs[dst, k] = src
        else:
            seg_offs.append(None)
            tail_offs.append(None)
            s = ph.send_idx.shape[1]
            send_idx[:, k, :s] = ph.send_idx
            for (src, _dst) in ph.perm:
                # real lanes = the entry's actual send count for that src
                cnt = int((ph.recv_idx[_dst] < topo.npoint_pad).sum())
                send_mask[src, k, :cnt] = 1.0
                dsts[src, k] = _dst
                srcs[_dst, k] = src
            for d in range(P):
                recv = ph.recv_idx[d]
                valid = recv < topo.npoint_pad        # OOB marker = pad
                pos = np.flatnonzero(valid)
                locmap[d][recv[pos]] = owned_pad + k * s_max + pos
        # complete the partial matching to a full permutation: unmatched
        # senders push masked zeros to unmatched receivers, so every device
        # participates in every phase exactly once (the zero payload lands
        # in an unused ghost region)
        free_src = [d for d in range(P) if dsts[d, k] < 0]
        free_dst = [d for d in range(P) if srcs[d, k] < 0]
        for s_, t_ in zip(free_src, free_dst):
            dsts[s_, k] = t_
            srcs[t_, k] = s_
    npad_start = len(perms)
    while len(perms) < nphases:
        # fake_sends: padded phases become full SELF-permutations carrying a
        # real payload (see docstring); otherwise inert empty perms
        perms.append(tuple((d, d) for d in range(P)) if fake_sends > 0
                     else ())
        seg_offs.append(None)
        tail_offs.append(None)
    if n_fake:
        # contiguous-run segments scattered in the front region: production
        # send lists are sorted runs (comm-first grouped relabel), so the
        # fake phases exercise the SAME segs pack path a real multi-shard
        # graph uses.  fake_tail_frac carves the trailing lanes into a
        # strided (non-contiguous) GATHER TAIL
        check(0.0 <= fake_tail_frac <= 0.5,
              "fake_tail_frac must be in [0, 0.5], got %r", fake_tail_frac)
        n_tail = int(round(n_fake * fake_tail_frac))
        n_slice = n_fake - n_tail
        nseg = min(6, max(1, n_slice // LANE)) if n_slice else 0
        if nseg:
            m = n_slice // nseg
            lens = [m] * (nseg - 1) + [n_slice - m * (nseg - 1)]
        else:
            lens = []
        offs, off = [], 0
        for L in lens:
            offs.append((off, L))
            off += L
        tail = (off, n_tail) if n_tail else None
        for k in range(npad_start, nphases):
            seg_offs[k] = tuple(offs)
            tail_offs[k] = tail
            for p_i, pt in enumerate(parts):
                width = min(pt.nowned, 3 * n_fake)
                stride = width // max(nseg, 1)
                off = 0
                for r, L in enumerate(lens):
                    start = r * stride
                    send_idx[p_i, k, off:off + L] = np.arange(
                        start, start + L, dtype=np.int32)
                    send_mask[p_i, k, off:off + L] = 1.0
                    off += L
                if n_tail:
                    # stride-2 ascending columns: sorted but never a
                    # contiguous run — the pack must GATHER these lanes,
                    # like a real small-group tail
                    send_idx[p_i, k, off:off + n_tail] = np.arange(
                        0, 2 * n_tail, 2, dtype=np.int32)
                    send_mask[p_i, k, off:off + n_tail] = 1.0
    # prefix-packed phases: pad send lanes with the last REAL index (not 0)
    # so the send lists stay sorted across padding (segmented phases pad
    # per segment above)
    for p_i in range(P):
        for k in range(nphases):
            if seg_offs[k] is not None:
                continue
            n = int((send_mask[p_i, k] > 0).sum())
            if 0 < n < s_max:
                send_idx[p_i, k, n:] = send_idx[p_i, k, n - 1]
    # phases beyond the real schedule (e.g. the padded phase of a comm-free
    # mesh) still need a full self-permutation: the completion inside the
    # loop above only covers real phases
    ids = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, nphases))
    dsts[dsts < 0] = ids[dsts < 0]
    srcs[srcs < 0] = ids[srcs < 0]

    for d in range(len(parts)):
        check(int(locmap[d].min(initial=0)) >= 0,
              "ghost point unmapped on shard %d", d)
    return TLayout(
        bp=bp, owned_pad=owned_pad, s_max=s_max, nphases=nphases, ndev=ndev,
        perms=perms, locmap=locmap, send_idx=send_idx, send_mask=send_mask,
        dsts=dsts, srcs=srcs, inter_slice=inter_slice,
        seg_offs=tuple(seg_offs), tail_offs=tuple(tail_offs),
    )


def device_faces(part: MeshPartition, lay: TLayout) -> tuple[np.ndarray, np.ndarray]:
    """Faces/normals in device-column coordinates for one shard."""
    lm = lay.locmap[part.part_id]
    return lm[part.faces].astype(np.int32), part.normals


def device_inv_scale(part: MeshPartition, lay: TLayout) -> np.ndarray:
    """1/V at owned device columns, 0 at ghosts/padding (ghost grads are
    overwritten by the exchange; zero-scaling keeps them deterministic)."""
    s = np.zeros(lay.ndev, dtype=np.float64)
    s[: part.nowned] = 1.0 / part.volume[: part.nowned]
    return s


def device_state(values: np.ndarray, part: MeshPartition, lay: TLayout,
                 nv_pad: int) -> np.ndarray:
    """(npoint, nvar) host state -> (NV, ndev) transposed device state."""
    nvar = values.shape[1]
    check(nvar <= nv_pad, "nvar %d exceeds padded NV %d", nvar, nv_pad)
    out = np.zeros((nv_pad, lay.ndev), dtype=values.dtype)
    out[:nvar, lay.locmap[part.part_id]] = values.T
    return out
