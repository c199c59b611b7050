"""Carry a JAX model's plan data across to the port.

`plans_from_jax(model)` reads the layout, the exchange tables and the
bulk / boundary / interior plans of every shard of a
`cfd_proxy_tpu.models.GreenGaussPallas` (or its `PSDFluxModel`: the plans
do not depend on the op) through `np.asarray` and returns the arrays
`GreenGaussTorch.from_arrays` / `PSDFluxModel.from_arrays` load
(models/gradients.py PLAN_KEYS); `state_from_jax(state)` returns its
distributed `var_T`.  Both packages then compute on identical plan data,
so a comparison of their outputs tests the kernels and the step
composition and nothing else.  `sweeps_from_jax(model)` does the same for
the ELL backend: a `cfd_proxy_tpu.models.GreenGaussModel`'s tables and halo
lists, which `models.gradients_ell.GreenGaussModel(..., arrays=)` loads.

This module takes the JAX objects as it finds them and converts with numpy
only: it imports no JAX.  bf16 weights (a model built with
meta_dtype="bfloat16") arrive as numpy arrays of ml_dtypes' bfloat16,
which `torch.from_numpy` does not take; they cross bit for bit as uint16
and come out as a torch bf16 tensor, which `from_arrays` loads as it is.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from cfd_proxy_tpu_torch.models.gradients import CLASSES
from cfd_proxy_tpu_torch.ops.plan import (BlockPlan, compact_slot_w,
                                          compact_src_cols, compact_widx)
from cfd_proxy_tpu_torch.ops.sweep_ell import DeviceSweep
from cfd_proxy_tpu_torch.utils.errors import check

SWEEP_FIELDS = tuple(f.name for f in fields(DeviceSweep))


def _class_arrays(model, cls: str) -> dict:
    """One class's (P, ...) plan arrays in the port's layout for the
    model's kernel (models/gradients.py CLASS_KEYS).

    Gather: the reference's rectangular `slot_idx`, `slot_w` and `ext_idx`
    as they are.  Packed: the compact `src_cols` and `widx` are derived
    from the reference's `slot_idx`, `ext_idx`, `block_ids` and `ep`
    (ops/plan.py::compact_src_cols, compact_widx), and `ext_idx` is carried
    as it is; with kcompact off the reference keeps
    rectangular tables, which the port stores as the compact layout with
    every slot at full width."""
    pa = {k: np.asarray(v) for k, v in model._plans_dev[cls].items()}
    ep, ks, nb = model._dims[cls]
    bp = int(model.bp)
    wks = model._wks[cls] or (bp,) * ks
    slot_w = pa["slot_w"]
    bf16 = slot_w.dtype.name == "bfloat16"
    check(bf16 or slot_w.dtype == np.float32, "plans_from_jax needs f32 or "
          "bf16 weights, got %s", slot_w.dtype)
    if bf16:                    # the bits, until they become a torch tensor
        slot_w = np.ascontiguousarray(slot_w).view(np.uint16)
    common = {
        "block_ids": pa["block_ids"].astype(np.int32),
        "scale": np.ascontiguousarray(pa["scale"], np.float32),
        "wks": tuple(wks),
    }
    if not model.packed:
        return {**common, "ep": int(ep),
                "slot_idx": np.ascontiguousarray(pa["slot_idx"], np.int32),
                "slot_w": _weights(slot_w, bf16),
                "ext_idx": np.ascontiguousarray(pa["ext_idx"], np.int32)}
    if slot_w.ndim == 5:                        # rectangular (P, nb, K, 3, bp)
        slot_w = compact_slot_w(slot_w, wks)
    # compact_src_cols and compact_widx read block_ids, slot_idx, ext_idx
    # and ep only; the rectangular weights are not rebuilt for them
    plans = [BlockPlan(
        npoint_dev=model.layout.ndev, bp=bp, ep=ep, kslots=ks, nblocks=nb,
        block_ids=pa["block_ids"][d], slot_idx=pa["slot_idx"][d], slot_w=None,
        ext_idx=pa["ext_idx"][d], scale=None)
        for d in range(len(model.parts))]
    return {**common,
            "src_cols": np.stack([compact_src_cols(pl, wks) for pl in plans]),
            "widx": np.stack([compact_widx(pl, wks) for pl in plans]),
            "ext_idx": np.ascontiguousarray(pa["ext_idx"], np.int32),
            "slot_w": _weights(slot_w, bf16)}


def _weights(slot_w: np.ndarray, bf16: bool):
    """f32 weights as a numpy array; bf16 weights (their uint16 bits) as a
    torch bf16 tensor."""
    if bf16:            # a writable copy: torch takes no read-only arrays
        return torch.from_numpy(np.array(slot_w)).view(torch.bfloat16)
    return np.ascontiguousarray(slot_w)


def plans_from_jax(model) -> dict:
    """Plan arrays of a GreenGaussPallas or PSDFluxModel (packed or gather
    kernel, f32 or bf16 weights; `inter_slice` carries the model's
    `slice_size` routing across), in the port's layout.  The arrays are the same for both ops; the model
    they are loaded into takes the reference's dtype options
    (`GreenGaussTorch.from_arrays(..., meta_dtype=...)`)."""
    lay = model.layout
    return {
        "kernel": model.kernel, "ndev": lay.ndev, "bp": int(model.bp), "s_max": lay.s_max,
        "ghost_start": lay.ghost_start,
        "locmap": [np.asarray(m, np.int64) for m in lay.locmap],
        "send_idx": np.asarray(model._send_idx),
        "send_mask": np.asarray(model._send_mask),
        "pack_scale": np.asarray(model._pack_scale),
        "dsts": np.asarray(model._dsts), "srcs": np.asarray(model._srcs),
        "perms": list(lay.perms), "has_comm": bool(model._has_comm),
        "inter_slice": np.asarray(lay.inter_slice, bool),
        "classes": {c: _class_arrays(model, c) for c in CLASSES},
    }


def state_from_jax(state: dict) -> np.ndarray:
    """(P, NV, ndev) f32 `var_T` of a GreenGaussPallas state."""
    var_T = np.asarray(state["var_T"])
    check(var_T.ndim == 3, "state_from_jax expects a stacked (P, NV, ndev) "
          "var_T, got %s", var_T.shape)
    return np.ascontiguousarray(var_T, np.float32)


def sweeps_from_jax(model) -> dict:
    """Tables and halo lists of a `cfd_proxy_tpu.models.GreenGaussModel`
    (the ELL backend), as the host arrays `models.gradients_ell.
    GreenGaussModel(..., arrays=)` loads (ARRAY_KEYS): every DeviceSweep
    field stacked over the shards, send_idx / recv_idx (P, nph, S) and the
    phases' pairs."""
    ds, halo = model.dsweep, model.halo
    return {
        "npoint_pad": int(model.npoint_pad),
        "sweep": {f: np.asarray(getattr(ds, f)) for f in SWEEP_FIELDS},
        "send_idx": np.asarray(halo.send_idx),
        "recv_idx": np.asarray(halo.recv_idx),
        "perms": tuple(tuple(p) for p in halo.perms),
    }
