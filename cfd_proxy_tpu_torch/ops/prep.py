"""Offline sweep preprocessing for the ELL backend (NumPy).

NumPy copy of `cfd_proxy_tpu/ops/prep.py` (the port imports nothing of the
JAX package); tests/test_torch_host.py holds the two equal by AST and
output.  `build_sweep_plan` classifies faces boundary (touching a send
point) or interior, reorders them [boundary | pad | interior | pad], and
builds the padded ELL incidence tables the ELL sweep of `ops/sweep_ell.py`
reads:

- full (every face; the bulk sweep),
- boundary (compact rows over boundary-adjacent points),
- interior (full rows, interior faces only),

with slots sorted by incidence id `2*face + side`, so that a sequential
per-point sum reproduces the golden accumulation order on the plan's faces
and boundary∘interior equals the full sweep bit for bit in f64; and the
sorted incidence rows (`row_face/row_sign/row_point`) of the segment-sum
form.  `SweepPads.max_of` gives every shard's plan the same shapes (the
two-pass build).  Padding is inert: sign 0, zero normals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy_tpu_torch.utils.errors import check
from cfd_proxy_tpu_torch.utils import round_up

LANE = 128
SUBLANE = 8




@dataclass
class SweepPads:
    """Padded-size targets, so plans for different shards get uniform shapes.

    `shard_map` traces ONE program for every shard, so all per-shard metadata
    arrays must share shapes; per-shard differences live in array *contents*
    (inert padding: sign 0 / zero normals).  Build each shard's plan twice:
    once with pads=None to measure, then with `SweepPads.max_of(plans)`.
    """

    nface_b_pad: int
    nface_i_pad: int
    npoint_pad: int
    nbp_pad: int
    nrow_pad: int
    maxdeg_full: int
    maxdeg_b: int
    maxdeg_i: int

    @staticmethod
    def max_of(plans: list["SweepPlan"]) -> "SweepPads":
        return SweepPads(
            nface_b_pad=max(p.nface_b_pad for p in plans),
            nface_i_pad=max(p.nface_pad - p.nface_b_pad for p in plans),
            npoint_pad=max(p.npoint_pad for p in plans),
            nbp_pad=max(p.ell_boundary.inc_face.shape[0] for p in plans),
            nrow_pad=max(p.row_face.shape[0] for p in plans),
            maxdeg_full=max(p.ell_full.maxdeg for p in plans),
            maxdeg_b=max(p.ell_boundary.maxdeg for p in plans),
            maxdeg_i=max(p.ell_interior.maxdeg for p in plans),
        )


@dataclass
class EllBlock:
    """Padded ELL incidence set for one face class.

    rows: which points carry rows.  `points is None` → rows are all points
    [0, npoint_pad); otherwise `points` is a compact sorted list and results
    must be scatter-added back (indices are unique, so the scatter is trivially
    race-free).
    inc_face is *relative to the face slice* owned by this block.
    """

    points: np.ndarray | None   # (nrows,) i32 or None
    inc_face: np.ndarray        # (nrows_pad, maxdeg) i32
    inc_sign: np.ndarray        # (nrows_pad, maxdeg) i8 (+1/-1/0)

    @property
    def maxdeg(self) -> int:
        return int(self.inc_face.shape[1])


@dataclass
class SweepPlan:
    """Device-ready metadata for the Green-Gauss sweep on one partition."""

    npoint: int
    npoint_pad: int
    nowned: int
    nface: int                 # real faces
    nface_b: int               # real boundary faces
    nbp: int                   # real boundary-adjacent point count
    nface_b_pad: int           # padded boundary slice length
    nface_pad: int             # total padded face count (b_pad + i_pad)
    faces: np.ndarray          # (nface_pad, 2) i32 — [boundary|pad|interior|pad]
    normals: np.ndarray        # (nface_pad, 3) — zero rows at padding
    face_perm: np.ndarray      # (nface,) i32: reordered position -> original id
    ell_full: EllBlock         # all faces (face ids into the padded array)
    ell_boundary: EllBlock     # boundary slice (compact rows)
    ell_interior: EllBlock     # interior slice (full rows; face ids relative
                               # to the interior slice start)
    row_face: np.ndarray       # (nrow_pad,) i32 into padded face array
    row_sign: np.ndarray       # (nrow_pad,) i8
    row_point: np.ndarray      # (nrow_pad,) i32, sorted ascending


def _build_ell(
    point_of_row: np.ndarray,   # incidence target point per incidence
    face_of_row: np.ndarray,    # face id per incidence (already slice-relative)
    sign_of_row: np.ndarray,
    order_key: np.ndarray,      # incidence id for deterministic slot order
    nrows: int,                 # ELL row count (npoint or len(points))
    row_of_point: np.ndarray | None,  # map point -> ELL row (None = identity)
    pad_rows: int,
    pad_face: int,
    maxdeg_min: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Bucket incidences into (row, slot) with slots sorted by order_key."""
    rows = point_of_row if row_of_point is None else row_of_point[point_of_row]
    # sort by (row, order_key) -> slot index = rank within row
    perm = np.lexsort((order_key, rows))
    rows_s = rows[perm]
    face_s = face_of_row[perm]
    sign_s = sign_of_row[perm]
    # slot index within each row
    counts = np.bincount(rows_s, minlength=nrows)
    maxdeg = int(counts.max()) if counts.size else 0
    maxdeg = max(maxdeg, 1, maxdeg_min)
    starts = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(rows_s.size, dtype=np.int64) - starts[rows_s]
    inc_face = np.full((pad_rows, maxdeg), pad_face, dtype=np.int32)
    inc_sign = np.zeros((pad_rows, maxdeg), dtype=np.int8)
    inc_face[rows_s, slot] = face_s
    inc_sign[rows_s, slot] = sign_s
    return inc_face, inc_sign


def build_sweep_plan(
    faces: np.ndarray,
    normals: np.ndarray,
    npoint: int,
    nowned: int,
    send_points: np.ndarray | None = None,
    *,
    row_tile: int = SUBLANE * LANE,
    pads: SweepPads | None = None,
) -> SweepPlan:
    """Classify, reorder, pad and index the face set for device sweeps."""
    faces = np.asarray(faces, dtype=np.int32)
    normals = np.asarray(normals, dtype=np.float64)
    nface = int(faces.shape[0])
    check(normals.shape == (nface, 3), "normals shape %s", normals.shape)

    if send_points is None or len(send_points) == 0:
        is_send = np.zeros(npoint, dtype=bool)
    else:
        is_send = np.zeros(npoint, dtype=bool)
        is_send[np.asarray(send_points)] = True
    is_boundary = is_send[faces[:, 0]] | is_send[faces[:, 1]]

    # stable reorder: boundary first, interior after (preserves relative order)
    b_ids = np.flatnonzero(is_boundary)
    i_ids = np.flatnonzero(~is_boundary)
    nface_b = int(b_ids.size)
    nface_i = int(i_ids.size)
    # each slice gets >=1 inert pad row (zero normal) for ELL slot padding
    nface_b_pad = round_up(nface_b + 1, SUBLANE)
    nface_i_pad = round_up(nface_i + 1, SUBLANE)
    if pads is not None:
        check(pads.nface_b_pad >= nface_b_pad, "pads.nface_b_pad too small")
        check(pads.nface_i_pad >= nface_i_pad, "pads.nface_i_pad too small")
        nface_b_pad = pads.nface_b_pad
        nface_i_pad = pads.nface_i_pad
    nface_pad = nface_b_pad + nface_i_pad

    face_perm = np.concatenate([b_ids, i_ids]).astype(np.int32)
    faces_pad = np.zeros((nface_pad, 2), dtype=np.int32)
    normals_pad = np.zeros((nface_pad, 3), dtype=np.float64)
    faces_pad[:nface_b] = faces[b_ids]
    normals_pad[:nface_b] = normals[b_ids]
    faces_pad[nface_b_pad : nface_b_pad + nface_i] = faces[i_ids]
    normals_pad[nface_b_pad : nface_b_pad + nface_i] = normals[i_ids]

    npoint_pad = round_up(max(npoint, 1), SUBLANE)
    if pads is not None:
        check(pads.npoint_pad >= npoint_pad, "pads.npoint_pad too small")
        npoint_pad = pads.npoint_pad

    # incidence table in *reordered* face numbering (padded positions)
    new_pos = np.empty(nface, dtype=np.int64)
    new_pos[b_ids] = np.arange(nface_b)
    new_pos[i_ids] = nface_b_pad + np.arange(nface_i)
    # incidence id preserves within-class original order: (new_pos, side)
    pts = np.concatenate([faces[:, 0], faces[:, 1]])
    fids = np.concatenate([new_pos, new_pos])
    signs = np.concatenate(
        [np.ones(nface, dtype=np.int8), -np.ones(nface, dtype=np.int8)]
    )
    inc_id = np.concatenate([2 * new_pos, 2 * new_pos + 1])

    f_face, f_sign = _build_ell_tuple(
        pts, fids, signs, inc_id, npoint, None, npoint_pad, pad_face=nface_pad - 1,
        maxdeg_min=pads.maxdeg_full if pads else 1,
    )
    ell_full = EllBlock(points=None, inc_face=f_face, inc_sign=f_sign)

    # boundary block: compact rows over boundary-adjacent points
    bmask = fids < nface_b
    bpts_all = pts[bmask]
    b_points = np.unique(bpts_all).astype(np.int32)
    nbp = int(b_points.size)
    nbp_pad = round_up(max(nbp, 1), SUBLANE)
    if pads is not None:
        check(pads.nbp_pad >= nbp_pad, "pads.nbp_pad too small")
        nbp_pad = pads.nbp_pad
    row_of_point = np.full(npoint, -1, dtype=np.int64)
    row_of_point[b_points] = np.arange(nbp)
    b_face, b_sign = _build_ell_tuple(
        bpts_all, fids[bmask], signs[bmask], inc_id[bmask],
        nbp, row_of_point, nbp_pad, pad_face=nface_b_pad - 1,
        maxdeg_min=pads.maxdeg_b if pads else 1,
    )
    # compact rows padded to nbp_pad: pad point target = an inert slot; use
    # point npoint_pad-1's row only via scatter mask — store pad as npoint_pad-1
    b_points_pad = np.full(nbp_pad, npoint_pad - 1, dtype=np.int32)
    b_points_pad[:nbp] = b_points
    ell_boundary = EllBlock(points=b_points_pad, inc_face=b_face, inc_sign=b_sign)

    # interior block: full rows, face ids relative to interior slice start
    imask = ~bmask
    i_face, i_sign = _build_ell_tuple(
        pts[imask], fids[imask] - nface_b_pad, signs[imask], inc_id[imask],
        npoint, None, npoint_pad, pad_face=nface_i_pad - 1,
        maxdeg_min=pads.maxdeg_i if pads else 1,
    )
    ell_interior = EllBlock(points=None, inc_face=i_face, inc_sign=i_sign)

    # sorted incidence rows (segment layout), sorted by (point, incidence id)
    perm = np.lexsort((inc_id, pts))
    nrow = 2 * nface
    nrow_pad = round_up(max(nrow, 1), row_tile)
    if pads is not None:
        check(pads.nrow_pad >= nrow_pad, "pads.nrow_pad too small")
        nrow_pad = pads.nrow_pad
    row_face = np.full(nrow_pad, nface_pad - 1, dtype=np.int32)
    row_sign = np.zeros(nrow_pad, dtype=np.int8)
    row_point = np.full(nrow_pad, npoint_pad - 1, dtype=np.int32)
    row_face[:nrow] = fids[perm]
    row_sign[:nrow] = signs[perm]
    row_point[:nrow] = pts[perm]

    return SweepPlan(
        npoint=npoint,
        npoint_pad=npoint_pad,
        nowned=nowned,
        nface=nface,
        nface_b=nface_b,
        nbp=nbp,
        nface_b_pad=nface_b_pad,
        nface_pad=nface_pad,
        faces=faces_pad,
        normals=normals_pad,
        face_perm=face_perm,
        ell_full=ell_full,
        ell_boundary=ell_boundary,
        ell_interior=ell_interior,
        row_face=row_face,
        row_sign=row_sign,
        row_point=row_point,
    )


def _build_ell_tuple(pts, fids, signs, inc_id, nrows, row_of_point, pad_rows,
                     pad_face, maxdeg_min=1):
    return _build_ell(
        point_of_row=pts,
        face_of_row=fids.astype(np.int32),
        sign_of_row=signs,
        order_key=inc_id,
        nrows=nrows,
        row_of_point=row_of_point,
        pad_rows=pad_rows,
        pad_face=pad_face,
        maxdeg_min=maxdeg_min,
    )
