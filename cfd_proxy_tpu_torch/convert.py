"""Carry a JAX model's plan data across to the port.

`plans_from_jax(model)` reads the bulk-class plan of a one-shard
`cfd_proxy_tpu.models.GreenGaussPallas` through `np.asarray` and returns the
arrays `GreenGaussTorch.from_arrays` loads (models/gradients.py PLAN_KEYS);
`state_from_jax(state)` returns its distributed `var_T`.  Both packages then
compute on identical plan data, so a comparison of their outputs tests the
kernels and nothing else.

This module takes the JAX objects as it finds them and converts with numpy
only: it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from cfd_proxy_tpu.utils.errors import check
from cfd_proxy_tpu_torch.ops.plan import BlockPlan, compact_slot_w, compact_src_cols


def plans_from_jax(model) -> dict[str, np.ndarray]:
    """Bulk plan arrays of a one-shard GreenGaussPallas model (packed kernel,
    f32 weights), in the port's compact layout.

    The compact `src_cols` are derived from the reference's `slot_idx`,
    `ext_idx`, `block_ids` and `ep` (ops/plan.py::compact_src_cols).  With
    kcompact off the reference keeps rectangular tables; the port stores
    them as the compact layout with every slot at full width."""
    check(len(model.parts) == 1, "plans_from_jax converts one-shard models, "
          "got %d shards", len(model.parts))
    check(model.packed and model.op == "gg",
          "plans_from_jax converts the packed Green-Gauss model")
    pa = model._plans_dev["bulk"]
    ep, ks, nb = model._dims["bulk"]
    bp = int(model.bp)
    wks = model._wks["bulk"]
    if wks is None:
        wks = (bp,) * ks
    block_ids = np.asarray(pa["block_ids"])[0].astype(np.int32)
    slot_idx = np.asarray(pa["slot_idx"])[0]
    ext_idx = np.asarray(pa["ext_idx"])[0]
    scale = np.asarray(pa["scale"])[0]
    slot_w = np.asarray(pa["slot_w"])[0]
    check(slot_w.dtype == np.float32, "plans_from_jax needs f32 weights, got "
          "%s", slot_w.dtype)
    if slot_w.ndim == 4:                        # rectangular (nb, K, 3, bp)
        slot_w = compact_slot_w(slot_w, wks)
    lay = model.layout
    # compact_src_cols reads block_ids, slot_idx, ext_idx and ep only; the
    # rectangular weights are not rebuilt for it
    plan = BlockPlan(npoint_dev=lay.ndev, bp=bp, ep=ep, kslots=ks,
                     nblocks=nb, block_ids=block_ids, slot_idx=slot_idx,
                     slot_w=slot_w, ext_idx=ext_idx, scale=scale)
    return {
        "block_ids": block_ids,
        "src_cols": compact_src_cols(plan, wks),
        "slot_w": np.ascontiguousarray(slot_w, np.float32),
        "scale": np.ascontiguousarray(scale, np.float32),
        "wks": np.asarray(wks, np.int64),
        "locmap": np.asarray(lay.locmap[0], np.int64),
        "ndev": np.asarray(lay.ndev, np.int64),
        "bp": np.asarray(bp, np.int64),
    }


def state_from_jax(state: dict) -> np.ndarray:
    """(NV, ndev) f32 `var_T` of a one-shard GreenGaussPallas state."""
    var_T = np.asarray(state["var_T"])
    check(var_T.ndim == 3 and var_T.shape[0] == 1,
          "state_from_jax converts one-shard states, got var_T %s",
          var_T.shape)
    return np.ascontiguousarray(var_T[0], np.float32)
