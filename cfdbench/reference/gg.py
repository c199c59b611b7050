"""The plain reference: Green-Gauss gradients on the global mesh in float64.

CFD-Proxy's `compute_gradients_gg`: for every face (p0, p1) with area-weighted
normal n and every variable v,

    avg = (var[p0, v] + var[p1, v]) / 2
    grad[p0, v, :] += avg · n
    grad[p1, v, :] -= avg · n

then each point's sums are divided by its dual-cell volume.  Plain PyTorch on
whatever device it is given, in blocks of faces so that the 152³ mesh fits
beside nothing else; it reads only the mesh and the state the benchmark made.

`chain` follows the chained update a solver built on the proxy runs:
v ← v + c · ∂v/∂x (the gradients' first component), each step's gradients
taken from the state it carries.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
FACE_BLOCK = 1 << 21


class Mesh64:
    """The mesh's arrays on a device: faces (int64), normals and volumes
    (f64)."""

    def __init__(self, faces: np.ndarray, normals: np.ndarray,
                 volume: np.ndarray, device):
        self.device = torch.device(device)
        self.p0 = torch.as_tensor(faces[:, 0].astype(np.int64),
                                  device=self.device)
        self.p1 = torch.as_tensor(faces[:, 1].astype(np.int64),
                                  device=self.device)
        self.normals = torch.as_tensor(np.asarray(normals, np.float64),
                                       device=self.device)
        self.volume = torch.as_tensor(np.asarray(volume, np.float64),
                                      device=self.device)


def gradients(mesh: Mesh64, var: torch.Tensor) -> torch.Tensor:
    """(npoint, nvar) f64 state → (npoint, nvar, 3) f64 gradients."""
    npoint, nvar = var.shape
    grad = torch.zeros((npoint, nvar, 3), dtype=F64, device=mesh.device)
    for lo in range(0, mesh.p0.shape[0], FACE_BLOCK):
        p0 = mesh.p0[lo:lo + FACE_BLOCK]
        p1 = mesh.p1[lo:lo + FACE_BLOCK]
        avg = 0.5 * (var[p0] + var[p1])
        contrib = avg[:, :, None] * mesh.normals[lo:lo + FACE_BLOCK, None, :]
        grad.index_add_(0, p0, contrib)
        grad.index_add_(0, p1, -contrib)
    return grad / mesh.volume[:, None, None]


def chain(mesh: Mesh64, var: torch.Tensor, coupling: float,
          steps: int) -> torch.Tensor:
    """The state after `steps` chained updates v ← v + coupling · ∂v/∂x."""
    for _ in range(steps):
        var = var + coupling * gradients(mesh, var)[:, :, 0]
    return var
