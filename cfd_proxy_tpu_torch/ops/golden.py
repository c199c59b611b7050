"""Golden-semantics Green-Gauss gradient sweep (NumPy, float64).

NumPy copy of `cfd_proxy_tpu/ops/golden.py` (the port imports nothing of
the JAX package), so a run of the port can verify itself without it;
tests/test_torch_plan.py holds the two bitwise equal.

The sequential C face loop of the reference's `compute_gradients_gg`,
reproduced with NumPy `ufunc.at`, which applies updates element by element
in index order, i.e. exactly the sequential face-loop accumulation order:

    for each face f with points (p0, p1):
        for each variable v:
            avg = 0.5 * (var[p0,v] + var[p1,v])
            grad[p0,v,:] += avg * normal[f,:]
            grad[p1,v,:] -= avg * normal[f,:]

The per-point accumulation order is increasing incidence id `2*f + side`
(side 0 = p0/+, side 1 = p1/−).
"""

from __future__ import annotations

import numpy as np


def compute_gradients_gg(
    var: np.ndarray,      # (npoint, nvar)
    faces: np.ndarray,    # (nface, 2) int
    normals: np.ndarray,  # (nface, 3)
) -> np.ndarray:
    """Accumulate raw Green-Gauss gradients; returns grad (npoint, nvar, 3)."""
    npoint, nvar = var.shape
    p0 = faces[:, 0]
    p1 = faces[:, 1]
    # contribution C[f, v, d] = 0.5*(var[p0,v]+var[p1,v]) * normal[f,d]
    avg = 0.5 * (var[p0] + var[p1])                    # (nface, nvar)
    contrib = avg[:, :, None] * normals[:, None, :]    # (nface, nvar, 3)
    # interleave (+ into p0, − into p1) per face: update order == C loop order
    idx = faces.reshape(-1)                            # (2*nface,) p0_0,p1_0,p0_1,...
    signed = np.stack([contrib, -contrib], axis=1)     # (nface, 2, nvar, 3)
    signed = signed.reshape(-1, nvar, 3)               # (2*nface, nvar, 3)
    grad = np.zeros((npoint, nvar, 3), dtype=np.result_type(var, normals))
    np.add.at(grad, idx, signed)
    return grad


def scale_gradients(grad: np.ndarray, volume: np.ndarray, nowned: int) -> np.ndarray:
    """Divide accumulated gradients by dual-cell volume at owned points.

    Ghost rows are left untouched — they are overwritten by the halo
    exchange anyway.
    """
    out = grad.copy()
    out[:nowned] /= volume[:nowned, None, None]
    return out
