"""Synthetic unstructured-mesh generator.

The reference ships/downloads the DLR F6 aircraft mesh plus a small test mesh
(SURVEY.md §3 "Datasets").  This sandbox has no network access, so the rebuild
generates meshes of comparable size and structure instead (SURVEY.md §7 hard
part 5): a jittered 3-D grid whose edges form the face graph (the median-dual
view an edge-based CFD solver like TAU uses: one "face" per point-pair), with

- optional random diagonal edges to skew point valence (unstructured-like
  degree distribution rather than a constant 6),
- optional random permutation of point ids to destroy structured banding
  (so coloring/reordering is exercised the way a real mesh would),
- geometrically consistent axis-edge normals and dual volumes, so that on the
  unjittered grid the Green-Gauss gradient of a linear field is exact at
  interior points (a semantic anchor test).

Faces are stored with p0 < p1 (normal flips sign on swap, so orientation
semantics `+into p0 / −into p1` are preserved).

The port's copy of `cfd_proxy_tpu/mesh/generator.py`: the port imports nothing of the
JAX package, so it carries its own host layer; tests/test_torch_host.py holds the
two equal (code and outputs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy_tpu_torch.utils.errors import check


@dataclass
class GlobalMesh:
    """Unpartitioned mesh: the generator/partitioner interchange format."""

    coords: np.ndarray   # (N, 3) f64
    faces: np.ndarray    # (F, 2) i32, global point ids, p0 < p1
    normals: np.ndarray  # (F, 3) f64
    volume: np.ndarray   # (N,) f64

    @property
    def npoint(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nface(self) -> int:
        return int(self.faces.shape[0])


def generate_mesh(
    nx: int,
    ny: int,
    nz: int,
    *,
    spacing: float = 1.0,
    jitter: float = 0.0,
    diag_frac: float = 0.0,
    shuffle: bool = True,
    seed: int = 0,
    stretch: float = 1.0,
    hub_frac: float = 0.0,
    hub_extra: int = 12,
) -> GlobalMesh:
    """Generate an edge-based mesh on an nx×ny×nz point grid.

    diag_frac: fraction of cells that additionally get a body-diagonal edge
    (valence skew).  jitter: coordinate noise in units of `spacing`.
    stretch: geometric z-spacing growth ratio (boundary-layer anisotropy,
    like the reference's F6 aircraft mesh): layer-k spacing is
    spacing·stretch^k, with dual volumes and dual-face areas following the
    geometry consistently — so the linear-field Green-Gauss anchor still
    holds at interior points, and the volume scaling exercises a large
    dynamic range (an f32 stress).

    hub_frac / hub_extra: HIGH-VALENCE TAIL mode (round-5 stress axis): a
    random hub_frac of points each gain up to hub_extra additional edges to
    second-shell grid neighbors, so the valence histogram carries the
    high-degree tail a real TAU median-dual mesh has near singular vertices
    (the base generator tops out at 8; hubs reach 6 + hub_extra ≈ 16-20,
    and hub NEIGHBORS gain +1-2 — the distribution the compact prefix
    layout, kslots sizing and the AUTO bp rule must survive).  Hub edges
    carry small diagonal-style normals (zero net area in expectation), so
    they stress the sweep's shape, not its physics.
    """
    check(nx >= 2 and ny >= 2 and nz >= 2, "need at least 2 points per axis")
    check(stretch > 0, "stretch must be positive")
    rng = np.random.default_rng(seed)
    N = nx * ny * nz
    h = float(spacing)

    # z layer positions + per-layer dual extents.  stretch == 1 keeps the
    # HISTORIC uniform convention bitwise (full-h duals everywhere, incl.
    # boundaries — committed fixtures/goldens depend on it); stretch != 1
    # uses the geometrically consistent half-extent boundary duals.
    if stretch == 1.0:
        zpos = np.arange(nz, dtype=np.float64) * h
        dzdual = np.full(nz, h)
    else:
        dz = h * np.power(float(stretch), np.arange(nz - 1))
        zpos = np.concatenate([[0.0], np.cumsum(dz)])
        dzdual = np.empty(nz)
        dzdual[0] = dz[0] / 2
        dzdual[-1] = dz[-1] / 2
        if nz > 2:
            dzdual[1:-1] = (dz[:-1] + dz[1:]) / 2

    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    coords = np.stack([ii * h, jj * h, zpos[kk]], axis=-1).reshape(N, 3)
    if jitter:
        noise = rng.uniform(-jitter, jitter, size=coords.shape)
        noise[:, :2] *= h
        noise[:, 2] *= dzdual[kk.ravel()]   # z noise in LOCAL layer units
        coords = coords + noise

    def gid(i, j, k):
        return (i * ny + j) * nz + k

    # axis-aligned edges; dual-face area vector per axis
    edges = []
    norms = []
    # x-edges: dual face spans h (y) × local layer extent (z)
    e0 = gid(ii[:-1, :, :], jj[:-1, :, :], kk[:-1, :, :]).ravel()
    e1 = gid(ii[:-1, :, :] + 1, jj[:-1, :, :], kk[:-1, :, :]).ravel()
    edges.append(np.stack([e0, e1], axis=1))
    n = np.zeros((e0.size, 3)); n[:, 0] = h * dzdual[kk[:-1, :, :].ravel()]
    norms.append(n)
    # y-edges
    e0 = gid(ii[:, :-1, :], jj[:, :-1, :], kk[:, :-1, :]).ravel()
    e1 = gid(ii[:, :-1, :], jj[:, :-1, :] + 1, kk[:, :-1, :]).ravel()
    edges.append(np.stack([e0, e1], axis=1))
    n = np.zeros((e0.size, 3)); n[:, 1] = h * dzdual[kk[:, :-1, :].ravel()]
    norms.append(n)
    # z-edges: dual face is an x-y plane, h×h regardless of stretch
    e0 = gid(ii[:, :, :-1], jj[:, :, :-1], kk[:, :, :-1]).ravel()
    e1 = gid(ii[:, :, :-1], jj[:, :, :-1], kk[:, :, :-1] + 1).ravel()
    edges.append(np.stack([e0, e1], axis=1))
    n = np.zeros((e0.size, 3)); n[:, 2] = h * h
    norms.append(n)

    if diag_frac > 0:
        ci, cj, ck = np.meshgrid(
            np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
        )
        ncell = ci.size
        pick = rng.random(ncell) < diag_frac
        d0 = gid(ci, cj, ck).ravel()[pick]
        d1 = gid(ci + 1, cj + 1, ck + 1).ravel()[pick]
        edges.append(np.stack([d0, d1], axis=1))
        # small geometric normal along the diagonal; keeps the sweep's
        # arithmetic shape, contributes zero net area in expectation
        dvec = coords[d1] - coords[d0]
        dlen = np.linalg.norm(dvec, axis=1, keepdims=True)
        norms.append(0.05 * h * h * dvec / np.maximum(dlen, 1e-300))

    if hub_frac > 0 and hub_extra > 0:
        check(0 < hub_frac <= 1.0, "hub_frac must be in (0, 1], got %r",
              hub_frac)
        # second-shell offsets, ordered so small hub_extra values pick a
        # spatially spread subset; (±1,±1,0)-class offsets cannot collide
        # with axis edges (distance 1) or diag edges ((1,1,1))
        offsets = [(2, 0, 0), (0, 2, 0), (0, 0, 2), (-2, 0, 0), (0, -2, 0),
                   (0, 0, -2), (1, 1, 0), (-1, -1, 0), (1, 0, 1),
                   (-1, 0, -1), (0, 1, 1), (0, -1, -1), (1, -1, 0),
                   (-1, 1, 0), (1, 0, -1), (-1, 0, 1), (0, 1, -1),
                   (0, -1, 1)][: int(hub_extra)]
        hubs = np.flatnonzero(rng.random(N) < hub_frac)
        hi = hubs // (ny * nz)
        hj = (hubs // nz) % ny
        hk = hubs % nz
        hub_edges = []
        for di, dj, dk in offsets:
            qi, qj, qk = hi + di, hj + dj, hk + dk
            ok = ((qi >= 0) & (qi < nx) & (qj >= 0) & (qj < ny)
                  & (qk >= 0) & (qk < nz))
            hub_edges.append(np.stack(
                [hubs[ok], gid(qi[ok], qj[ok], qk[ok])], axis=1))
        he = np.concatenate(hub_edges, axis=0)
        # canonicalize and dedupe (two nearby hubs can propose the same
        # pair); duplicates against axis/diag edges are impossible by the
        # offset geometry
        he = np.sort(he, axis=1)
        he = np.unique(he, axis=0)
        edges.append(he)
        dvec = coords[he[:, 1]] - coords[he[:, 0]]
        dlen = np.linalg.norm(dvec, axis=1, keepdims=True)
        norms.append(0.05 * h * h * dvec / np.maximum(dlen, 1e-300))

    faces = np.concatenate(edges, axis=0).astype(np.int64)
    normals = np.concatenate(norms, axis=0)
    volume = (h * h * dzdual[kk.ravel()]).astype(np.float64)

    if shuffle:
        perm = rng.permutation(N)          # new id of old point i is perm[i]
        inv = np.empty(N, dtype=np.int64)
        inv[perm] = np.arange(N)
        coords = coords[inv]
        volume = volume[inv]
        faces = perm[faces]

    # canonical orientation p0 < p1; flip normal when swapping
    swap = faces[:, 0] > faces[:, 1]
    faces[swap] = faces[swap][:, ::-1]
    normals[swap] = -normals[swap]

    # deterministic face order: sort by (p0, p1)
    order = np.lexsort((faces[:, 1], faces[:, 0]))
    faces = faces[order]
    normals = normals[order]

    check(int(faces.max()) < N and int(faces.min()) >= 0, "face index out of range")
    return GlobalMesh(
        coords=coords,
        faces=faces.astype(np.int32),
        normals=normals,
        volume=volume,
    )


def make_state(npoint: int, nvar: int, *, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Random per-point state `var[npoint, nvar]` (the reference's var array)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((npoint, nvar)).astype(dtype)
