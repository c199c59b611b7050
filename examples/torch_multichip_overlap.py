"""Example: P shards on one card — phase topology and the three exchange
schedules, on the PyTorch/CUDA port.

Counterpart of `examples/multichip_overlap.py` on `GreenGaussTorch`:

1. partition a mesh into P shards,
2. build the model with `slice_size` describing the nodes (shards within a
   node are colored into the earliest phases; the phases that cross nodes
   come later and travel through the collective transport under overlap),
3. inspect the halo-exchange phase schedule the edge coloring produced,
4. run all three schedules (the reference analogues: bulk-synchronous MPI,
   early receive, GASPI write + notify, here the fused sweep + push kernel)
   and check they agree with each other and with the f64 golden.

Timings come from the solver CLI (`python -m cfd_proxy_tpu_torch.solver
--parts 8 --schedule all`); this example shows the API and the agreement.
On the card by default; `--device cpu` runs the kernels' plain versions:

    python examples/torch_multichip_overlap.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state  # noqa: E402
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh  # noqa: E402
from cfd_proxy_tpu_torch.models import GreenGaussTorch  # noqa: E402
from cfd_proxy_tpu_torch.ops.golden import (compute_gradients_gg,  # noqa: E402
                                            scale_gradients)

SCHEDULES = ("bulk", "early", "overlap")


def main(nx=12, ny=12, nz=10, nparts=8, slice_size=4, device="cuda",
         verbose=True):
    """Returns (model, {"<s>_vs_golden", "<s>_vs_bulk": max errors})."""
    slice_size = min(slice_size, nparts)
    mesh = generate_mesh(nx, ny, nz, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(mesh, npart=nparts, ghost_layers=1)
    model = GreenGaussTorch(parts, nvar=7, slice_size=slice_size,
                            device=device)
    if verbose:
        print(f"mesh: {mesh.npoint} points / {mesh.nface} faces, "
              f"{nparts} shards, slice_size={slice_size}, {device}")
        print(f"halo topology: {model.nphases} phase(s), s_max "
              f"{model.s_max} columns")
        for k, perm in enumerate(model.perms):
            kind = ("inter-node, transport" if k in model.dcn_phases
                    else "intra-node, in the fused kernel")
            print(f"  phase {k}: {len(perm)} edges, {kind}")

    q0 = make_state(mesh.npoint, 7, seed=1)
    state = model.distribute_state(q0)
    grads = {s: model.gather_global(model.step(state, s)) for s in SCHEDULES}

    ref = scale_gradients(
        compute_gradients_gg(q0.astype(np.float64), mesh.faces, mesh.normals),
        mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)
    denom = max(1.0, float(np.abs(ref).max()))
    out = {}
    for s in SCHEDULES:
        out[f"{s}_vs_golden"] = float(np.abs(grads[s] - ref).max() / denom)
        if s != "bulk":
            out[f"{s}_vs_bulk"] = float(np.abs(grads[s] - grads["bulk"]).max())
    if verbose:
        for k, v in out.items():
            print(f"{k} = {v:.3e}")
        print("done")
    return model, out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=ap.parse_args().device)
