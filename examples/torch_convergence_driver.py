"""Example: a convergence-monitored steady-state solve on the PyTorch/CUDA
port.

Counterpart of `examples/convergence_driver.py` on `GreenGaussTorch`: a
residual monitor, a convergence criterion and a divergence guard around
the solver-mode API (`refresh_state`: var halo exchange + table rebuild).

The "physics": explicit pseudo-time iteration of the heat equation
∂q/∂t = ∇²q to steady state (a Laplace solve with Dirichlet boundary).  The
Laplacian is built from two chained Green-Gauss sweeps, the
gradient-of-gradient construction the multi-round ghost layers exist for:

    grad  = GG(q)            # model1: nvar=1 scalar → (gx, gy, gz)
    hess  = GG(gx, gy, gz)   # model2: nvar=3 → ∂d(gv)
    ∇²q   = ∂x gx + ∂y gy + ∂z gz   (trace of the Hessian)
    q    += dt·∇²q  at INTERIOR points;  residual = RMS(∇²q) there

Boundary points (open dual cells: their ± face normals do not close) are
held fixed, the Dirichlet data, and left out of the residual.  The driver
stops at the target reduction, the step cap, or on divergence (NaN or
growth), and reports which.  On the card by default; `--device cpu` runs
the kernels' plain versions:

    python examples/torch_convergence_driver.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state  # noqa: E402
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh  # noqa: E402
from cfd_proxy_tpu_torch.models import GreenGaussTorch  # noqa: E402
from cfd_proxy_tpu_torch.ops.plan import NV  # noqa: E402


def drive(nx=10, ny=10, nz=8, nparts=4, dt=0.1, target=0.1, max_steps=80,
          check_every=5, schedule="overlap", device="cuda", verbose=True):
    """Iterate q ← q + dt·∇²q to the target residual reduction.

    Returns (status, residuals): status is "converged" | "max_steps" |
    "diverged"; residuals the monitored RMS(∇²q) history."""
    mesh = generate_mesh(nx, ny, nz, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(mesh, nparts)
    grad_model = GreenGaussTorch(parts, nvar=1, device=device)
    div_model = GreenGaussTorch(parts, nvar=3, device=device)
    ndev = grad_model.ndev
    dev = grad_model.device

    # interior = closed dual cell: the ± face normals of a point sum to ~0
    defect = np.zeros((mesh.npoint, 3))
    np.add.at(defect, mesh.faces[:, 0], mesh.normals)
    np.add.at(defect, mesh.faces[:, 1], -mesh.normals)
    scale = np.median(np.linalg.norm(mesh.normals, axis=1))
    closed = np.linalg.norm(defect, axis=1) < 1e-6 * scale

    # device mask: owned AND interior columns (the update and residual set)
    upd = np.zeros((nparts, ndev), np.float32)
    for i, p in enumerate(grad_model.parts):
        upd[i, : p.nowned] = closed[p.global_ids[: p.nowned]]
    n_upd = int(upd.sum())
    upd = torch.from_numpy(upd).to(dev)
    if verbose:
        print(f"{mesh.npoint} points, {mesh.nface} faces on {nparts} "
              f"shard(s); dt={dt} schedule={schedule} {device}")

    q = make_state(mesh.npoint, 1, seed=1)
    state1 = grad_model.distribute_state(q, schedules=[schedule])

    def laplacian(state1):
        grad = grad_model.step(state1, schedule)        # (P, 3·NV, ndev)
        # rows d·NV+0 = (gx, gy, gz); the other state rows stay zero
        var2 = torch.zeros((nparts, NV, ndev), dtype=torch.float32,
                           device=dev)
        var2[:, :3] = grad[:, ::NV]
        state2 = div_model.refresh_state(var2, schedules=[schedule])
        hess = div_model.step(state2, schedule)
        # trace: ∂x gx + ∂y gy + ∂z gz (row d·NV+v of the second sweep)
        return hess[:, 0 * NV + 0] + hess[:, 1 * NV + 1] + hess[:, 2 * NV + 2]

    residuals = []
    status = "max_steps"
    step = -1
    for step in range(max_steps):
        lap = laplacian(state1)                         # (P, ndev)
        if step % check_every == 0 or step == max_steps - 1:
            r = float(((lap * upd) ** 2).sum().div(n_upd).sqrt())
            residuals.append(r)
            if verbose:
                print(f"step {step:3d}: residual {r:.6f}")
            if not np.isfinite(r) or (len(residuals) >= 2
                                      and r > 4 * residuals[0]):
                status = "diverged"
                break
            if r < target * residuals[0]:
                status = "converged"
                break
        # Dirichlet: interior points only; row 0 only (the padded state
        # rows must stay zero)
        var = state1["var_T"].clone()
        var[:, 0] += dt * (lap * upd)
        state1 = grad_model.refresh_state(var, schedules=[schedule])
    if verbose and residuals:
        print(f"{status} after {step + 1} steps "
              f"(residual {residuals[0]:.4f} -> {residuals[-1]:.4f})")
    return status, residuals


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    status, _ = drive(device=ap.parse_args().device)
    raise SystemExit(0 if status == "converged" else 1)
