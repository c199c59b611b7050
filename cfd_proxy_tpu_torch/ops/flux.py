"""Secondary face kernel: upwind PSD-style flux (`compute_psd_flux` analogue).

The reference carries a second face kernel with different arithmetic intensity
(`flux.c`, SURVEY.md §3, tagged [M]; the exact upstream formula was not
recoverable — the mount was empty — so the formula HERE is the frozen spec):
a conservative scalar-system upwind flux where var rows 0..2 are treated as a
velocity field u and all nvar rows as transported quantities q:

    uLn  = u_L · n                 (face-normal velocity, left state)
    uRn  = u_R · n
    a    = max(|uLn|, |uRn|)       (upwind dissipation speed)
    F_v  = 0.5*(uLn*q_L,v + uRn*q_R,v) − 0.5*a*(q_R,v − q_L,v)
    res[p0] += F ;  res[p1] -= F   (conservation)

Same gather/scatter skeleton as the Green-Gauss sweep (SURVEY.md §4.3) but
nonlinear, with a per-face max — so it exercises the framework's kernel
machinery beyond pure FMA accumulation.  Output is (npoint, nvar) (no ×3).

The directed-slot form used by the Pallas backend needs no extra metadata
beyond the Green-Gauss slot tables: with w = ±n (slot_w) and destination d /
other o,
    contrib(d) = 0.5*((u_d·w) q_d + (u_o·w) q_o)
                 − 0.5*max(|u_d·w|, |u_o·w|)*(q_o − q_d)
which equals ±F by the symmetry split (u·w is sign-covariant, |u·w| and
q_o − q_d sign-invariant/antisymmetric): conservation is exact.

The port's copy of `cfd_proxy_tpu/ops/flux.py`, the f64 golden its flux
model is held to (the port imports nothing of the JAX package);
tests/test_torch_host.py holds the two equal (code and outputs).
"""

from __future__ import annotations

import numpy as np


def compute_psd_flux(
    var: np.ndarray,      # (npoint, nvar), rows 0..2 of each point = velocity
    faces: np.ndarray,    # (nface, 2)
    normals: np.ndarray,  # (nface, 3)
) -> np.ndarray:
    """Golden NumPy flux accumulation (sequential C-loop order semantics)."""
    npoint, nvar = var.shape
    p0, p1 = faces[:, 0], faces[:, 1]
    vL, vR = var[p0], var[p1]       # gather each endpoint ONCE (dominant
    uLn = np.einsum("fd,fd->f", vL[:, :3], normals)   # memory traffic)
    uRn = np.einsum("fd,fd->f", vR[:, :3], normals)
    a = np.maximum(np.abs(uLn), np.abs(uRn))
    F = 0.5 * (uLn[:, None] * vL + uRn[:, None] * vR) \
        - 0.5 * a[:, None] * (vR - vL)
    res = np.zeros((npoint, nvar), dtype=np.result_type(var, normals))
    idx = faces.reshape(-1)
    signed = np.stack([F, -F], axis=1).reshape(-1, nvar)
    np.add.at(res, idx, signed)
    return res


def flux_residual_scale(res: np.ndarray, volume: np.ndarray, nowned: int) -> np.ndarray:
    """Volume scaling at owned points (same convention as gradients)."""
    out = res.copy()
    out[:nowned] /= volume[:nowned, None]
    return out
