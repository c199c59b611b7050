"""The benchmark's inputs: a generated unstructured mesh and a random state.

A frozen NumPy copy of the repository's mesh recipe (the jittered grid whose
edges form the face graph, with random body diagonals and a random point
numbering; `cfd_proxy_tpu_torch/mesh/generator.py`, without the stretch and
hub options no configuration uses), kept here so that a change to the program
cannot change the benchmark's work.  The same arrays go to the program and to
the reference.

The mesh is the configuration's: its recipe at the configuration's mesh seed
(0, as the repository's runs use it), the same for every run, so that no run
does more or less work than another (a different mesh partitions differently:
at eight shards two seeds' steps differed by 4 %).  The state comes from
`--seed`, through the seed sequence (seed, 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """An unpartitioned mesh: points, faces (p0 < p1), area-weighted face
    normals (f64) and dual-cell volumes (f64)."""

    coords: np.ndarray   # (N, 3) f64
    faces: np.ndarray    # (F, 2) i32
    normals: np.ndarray  # (F, 3) f64
    volume: np.ndarray   # (N,) f64

    @property
    def npoint(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nface(self) -> int:
        return int(self.faces.shape[0])


def check_seed(seed: int) -> int:
    if not isinstance(seed, int) or seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed!r}")
    return seed


def generate(nx: int, ny: int, nz: int, *, jitter: float, diag_frac: float,
             seed: int) -> Mesh:
    """The mesh of an nx × ny × nz point grid at unit spacing: axis edges
    with their dual-face areas, a body diagonal in a diag_frac share of the
    cells with a small normal along it, coordinates jittered by up to
    `jitter`, points numbered at random, faces sorted by (p0, p1); the
    random draws in the recipe's order from `default_rng(seed)`."""
    if min(nx, ny, nz) < 2:
        raise ValueError("need at least 2 points per axis")
    rng = np.random.default_rng(check_seed(seed))
    N = nx * ny * nz
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    coords = np.stack([ii, jj, kk], axis=-1).reshape(N, 3).astype(np.float64)
    if jitter:
        coords = coords + rng.uniform(-jitter, jitter, size=coords.shape)

    def gid(i, j, k):
        return (i * ny + j) * nz + k

    edges, norms = [], []
    for axis, (di, dj, dk) in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1))):
        sl = (slice(0, nx - di), slice(0, ny - dj), slice(0, nz - dk))
        a, b, c = ii[sl], jj[sl], kk[sl]
        e0 = gid(a, b, c).ravel()
        edges.append(np.stack([e0, gid(a + di, b + dj, c + dk).ravel()], 1))
        n = np.zeros((e0.size, 3))
        n[:, axis] = 1.0
        norms.append(n)
    if diag_frac > 0:
        ci, cj, ck = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                                 np.arange(nz - 1), indexing="ij")
        pick = rng.random(ci.size) < diag_frac
        d0 = gid(ci, cj, ck).ravel()[pick]
        d1 = gid(ci + 1, cj + 1, ck + 1).ravel()[pick]
        edges.append(np.stack([d0, d1], axis=1))
        dvec = coords[d1] - coords[d0]
        dlen = np.linalg.norm(dvec, axis=1, keepdims=True)
        norms.append(0.05 * dvec / np.maximum(dlen, 1e-300))
    faces = np.concatenate(edges).astype(np.int64)
    normals = np.concatenate(norms)
    volume = np.ones(N)

    perm = rng.permutation(N)              # new id of old point i
    inv = np.empty(N, dtype=np.int64)
    inv[perm] = np.arange(N)
    coords, volume, faces = coords[inv], volume[inv], perm[faces]
    swap = faces[:, 0] > faces[:, 1]
    faces[swap] = faces[swap][:, ::-1]
    normals[swap] = -normals[swap]
    order = np.lexsort((faces[:, 1], faces[:, 0]))
    return Mesh(coords=coords, faces=faces[order].astype(np.int32),
                normals=normals[order], volume=volume)


def state(npoint: int, nvar: int, seed: int) -> np.ndarray:
    """The solver state: (npoint, nvar) standard normals in f32, the type
    the configurations state; both sides read these values."""
    rng = np.random.default_rng([check_seed(seed), 1])
    return rng.standard_normal((npoint, nvar), dtype=np.float32)
