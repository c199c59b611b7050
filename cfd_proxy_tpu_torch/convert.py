"""Carry a JAX model's plan data across to the port.

`plans_from_jax(model)` reads the layout, the exchange tables and the
bulk / boundary / interior plans of every shard of a
`cfd_proxy_tpu.models.GreenGaussPallas` through `np.asarray` and returns
the arrays `GreenGaussTorch.from_arrays` loads (models/gradients.py
PLAN_KEYS); `state_from_jax(state)` returns its distributed `var_T`.  Both
packages then compute on identical plan data, so a comparison of their
outputs tests the kernels and the step composition and nothing else.

This module takes the JAX objects as it finds them and converts with numpy
only: it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from cfd_proxy_tpu.utils.errors import check
from cfd_proxy_tpu_torch.models.gradients import CLASSES
from cfd_proxy_tpu_torch.ops.plan import (BlockPlan, compact_slot_w,
                                          compact_src_cols)


def _class_arrays(model, cls: str) -> dict:
    """One class's (P, ...) plan arrays in the port's compact layout.

    The compact `src_cols` are derived from the reference's `slot_idx`,
    `ext_idx`, `block_ids` and `ep` (ops/plan.py::compact_src_cols).  With
    kcompact off the reference keeps rectangular tables; the port stores
    them as the compact layout with every slot at full width."""
    pa = {k: np.asarray(v) for k, v in model._plans_dev[cls].items()}
    ep, ks, nb = model._dims[cls]
    bp = int(model.bp)
    wks = model._wks[cls] or (bp,) * ks
    slot_w = pa["slot_w"]
    check(slot_w.dtype == np.float32, "plans_from_jax needs f32 weights, got "
          "%s", slot_w.dtype)
    if slot_w.ndim == 5:                        # rectangular (P, nb, K, 3, bp)
        slot_w = compact_slot_w(slot_w, wks)
    # compact_src_cols reads block_ids, slot_idx, ext_idx and ep only; the
    # rectangular weights are not rebuilt for it
    src_cols = np.stack([
        compact_src_cols(BlockPlan(
            npoint_dev=model.layout.ndev, bp=bp, ep=ep, kslots=ks,
            nblocks=nb, block_ids=pa["block_ids"][d],
            slot_idx=pa["slot_idx"][d], slot_w=None,
            ext_idx=pa["ext_idx"][d], scale=None), wks)
        for d in range(len(model.parts))])
    return {
        "block_ids": pa["block_ids"].astype(np.int32),
        "src_cols": src_cols,
        "slot_w": np.ascontiguousarray(slot_w, np.float32),
        "scale": np.ascontiguousarray(pa["scale"], np.float32),
        "wks": tuple(wks),
    }


def plans_from_jax(model) -> dict:
    """Plan arrays of a GreenGaussPallas model (packed kernel, f32 weights,
    every phase on the in-kernel transport), in the port's layout."""
    check(model.packed and model.op == "gg",
          "plans_from_jax converts the packed Green-Gauss model")
    check(not model._dcn_phases, "plans_from_jax: inter-slice phases "
          "(slice_size) come with ROADMAP queue 1 item 12")
    lay = model.layout
    return {
        "ndev": lay.ndev, "bp": int(model.bp), "s_max": lay.s_max,
        "ghost_start": lay.ghost_start,
        "locmap": [np.asarray(m, np.int64) for m in lay.locmap],
        "send_idx": np.asarray(model._send_idx),
        "send_mask": np.asarray(model._send_mask),
        "pack_scale": np.asarray(model._pack_scale),
        "dsts": np.asarray(model._dsts), "srcs": np.asarray(model._srcs),
        "perms": list(lay.perms), "has_comm": bool(model._has_comm),
        "classes": {c: _class_arrays(model, c) for c in CLASSES},
    }


def state_from_jax(state: dict) -> np.ndarray:
    """(P, NV, ndev) f32 `var_T` of a GreenGaussPallas state."""
    var_T = np.asarray(state["var_T"])
    check(var_T.ndim == 3, "state_from_jax expects a stacked (P, NV, ndev) "
          "var_T, got %s", var_T.shape)
    return np.ascontiguousarray(var_T, np.float32)
