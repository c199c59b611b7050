"""The reduced-precision options of the port against the JAX reference.

The reference's four options (`meta_dtype`, `src_dtype`, `grad_dtype`,
`halo_dtype`, each "float32" or "bfloat16") on the 9×8×7 test mesh at
bp 128, the port on CPU tensors (the kernels' plain versions) against
`GreenGaussPallas` / `PSDFluxModel` in interpret mode:

- the bf16 slot weights and the bf16 delta tables (`pack_srcs(...,
  src_format="bf16d")`) equal the reference's bit for bit;
- each sweep form (K1 ± init, K2 ± init, K3 in both formulations, with a
  bf16 push) on bf16 operands, both ops, against the reference's kernel:
  f32 outputs within 1e-6 of max|ref|, bf16 outputs within one bf16 ulp;
- the model at P ∈ {1, 4}, both kernels (bf16 sources with the packed one
  only), each option alone and all of them together, every schedule:
  against the reference model with the same bounds, and against the f64
  golden inside the reference's own bands (tests/test_pallas_model.py);
- the halo-only model's owned columns bitwise equal to the f32 model's and
  its ghost columns the bf16 rounding of their owners (with bf16 gradient
  stores too: ghosts equal to owners);
- the flux model with bf16 sources and gradient stores; the solver-mode
  runner on the full stack; `plans_from_jax` on bf16 weights; the
  refusals; the CLI with the full stack.
"""

import json

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu.mesh.partition import partition_mesh
from cfd_proxy_tpu.models import GreenGaussPallas
from cfd_proxy_tpu.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy_tpu_torch import solver
from cfd_proxy_tpu_torch.convert import plans_from_jax, state_from_jax
from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

NVAR = 5
BP = 128
PORT_TOL = 1e-6       # port vs reference, relative (FMA-contraction bound)
SCHEDULES = ("bulk", "early", "overlap")
BF = "bfloat16"
FULL = {"src_dtype": BF, "meta_dtype": BF, "grad_dtype": BF,
        "halo_dtype": BF}
OPTIONS = {"meta": {"meta_dtype": BF}, "src": {"src_dtype": BF},
           "grad": {"grad_dtype": BF}, "halo": {"halo_dtype": BF},
           "full": FULL}
# vs the f64 golden, the reference's bands (tests/test_pallas_model.py:
# 157-280); halo alone leaves every owned column f32, so the f32 gate
BANDS = {"meta": (1e-7, 1e-3), "src": (1e-7, 5e-3), "grad": (1e-5, 5e-3),
         "halo": (0.0, 1e-5), "full": (1e-5, 2e-2)}
# across schedules, relative to max|bulk|: f32 stores agree to FMA noise,
# bf16 stores round the boundary partial too (the reference's 1e-2)
CROSS = {"meta": 1e-6, "src": 1e-6, "halo": 1e-6, "grad": 1e-2,
         "full": 1e-2}
MODEL_CASES = [(P, k, o) for P in (1, 4) for k in ("packed", "gather")
               for o in OPTIONS if not (k == "gather" and o == "src")]


def _options(kernel, option):
    """An option set as the kernel takes it: the gather formulation has no
    bf16 sources, so its full stack is the other three."""
    kw = dict(OPTIONS[option])
    if kernel == "gather":
        kw.pop("src_dtype", None)
    return kw


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def gref(mesh, gvar):
    g = compute_gradients_gg(gvar.astype(np.float64), mesh.faces, mesh.normals)
    return scale_gradients(g, mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)


@pytest.fixture(scope="module")
def parts(mesh):
    return {P: partition_mesh(mesh, P, ghost_layers=1) for P in (1, 4)}


@pytest.fixture(scope="module")
def jax_models(parts, gvar):
    """(P, kernel, option, op) → the JAX model (fused overlap kernel forced
    at one shard), its state and its output per schedule; built once."""
    cache = {}

    def get(P, kernel, option, op="gg"):
        key = (P, kernel, option, op)
        if key not in cache:
            jm = GreenGaussPallas(parts[P], NVAR, bp=BP, interpret=True,
                                  kernel=kernel, op=op, force_rdma=P == 1,
                                  **_options(kernel, option))
            js = jm.distribute_state(gvar)
            cache[key] = (jm, js, {s: np.asarray(jm.step(js, s))
                                   for s in SCHEDULES})
        return cache[key]

    return get


def _t(a):
    """numpy → torch (a writable copy), bf16 (ml_dtypes) through its
    bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(t):
    """A bf16 tensor's bits as uint16 numpy."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _assert_close(got, want, what=""):
    """Port (torch) against reference (numpy or torch): f32 within PORT_TOL
    of max|want|; bf16 elementwise within one bf16 ulp plus PORT_TOL of
    max|want|."""
    want = _t(want) if isinstance(want, np.ndarray) else want
    assert got.dtype == want.dtype and got.shape == want.shape, what
    w = want.float()
    scale = float(w.abs().max())
    assert scale > 0, what
    err = (got.float() - w).abs()
    if got.dtype == torch.bfloat16:
        bound = bs.bf16_ulp(w) + PORT_TOL * scale
        assert bool((err <= bound).all()), (what, float(err.max()))
    else:
        assert float(err.max()) <= PORT_TOL * scale, (what, float(err.max()))


# ------------------------------------------------------ tables, bitwise

@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_bf16_weights_equal_reference_bitwise(parts, jax_models, kernel):
    """The port rounds its f32 plan weights to bf16 itself
    (`.to(torch.bfloat16)`): bit for bit the reference's
    `host.astype(jnp.bfloat16)`, every class, compact (packed) and
    rectangular (gather) layouts."""
    jm, _, _ = jax_models(4, kernel, "meta")
    tm = GreenGaussTorch(parts[4], NVAR, bp=BP, kernel=kernel, device="cpu",
                         meta_dtype=BF)
    for c, pl in tm.plans.items():
        ref = np.asarray(jm._plans_dev[c]["slot_w"])
        assert ref.dtype.name == "bfloat16"
        assert pl["slot_w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(pl["slot_w"]),
                                      ref.view(np.uint16), err_msg=c)


@pytest.mark.parametrize("P,bp,kcompact", [(4, 128, True), (1, 256, False)])
def test_pack_deltas_equal_reference_bitwise(parts, gvar, jax_models, P, bp,
                                             kcompact):
    """`pack_srcs(src_format="bf16d")` on the plans `plans_from_jax` carries
    across equals the reference's delta tables bit for bit, every class,
    pad lanes and pad entries included (rectangular tables with kcompact
    off: every slot at full width)."""
    if (P, bp, kcompact) == (4, BP, True):
        jm, js, _ = jax_models(4, "packed", "src")
    else:
        jm = GreenGaussPallas(parts[P], NVAR, bp=bp, interpret=True,
                              kcompact=kcompact, src_dtype=BF)
        js = jm.distribute_state(gvar)
    arrays = plans_from_jax(jm)
    var_T = _t(state_from_jax(js))
    before = bs.pack_srcs.d16_launches
    for c, ca in arrays["classes"].items():
        ref = np.asarray(js[f"tbl_{c}"])
        if ref.ndim == 5:                       # (P, nb, K, NV, bp)
            ref = np.concatenate([ref[:, :, k] for k in range(ref.shape[2])],
                                 -1)
        got = bs.pack_srcs(var_T, _t(ca["src_cols"]), src_format="bf16d",
                           block_ids=_t(ca["block_ids"]),
                           slots=_t(bs.slot_table(ca["wks"])), bp=jm.bp)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, c
        np.testing.assert_array_equal(_bits(got), ref.view(np.uint16),
                                      err_msg=c)
    assert bs.pack_srcs.d16_launches == before     # CPU: the plain version


# ----------------------------------------------- sweep forms vs kernels

def _jax_shard_call(fn_body, n_in, *args):
    """Run fn_body under shard_map on a one-device mesh, as the reference
    model calls its kernels."""
    import jax
    from jax.sharding import Mesh, PartitionSpec
    from cfd_proxy_tpu.models.gradients_pallas import AXIS, _shard_map

    one = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    spec = PartitionSpec(AXIS)
    fn = jax.jit(_shard_map(fn_body, one, in_specs=(spec,) * n_in,
                            out_specs=(spec, spec)))
    return [np.asarray(x) for x in fn(*args)]


@pytest.mark.parametrize("out16", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("form", ["K1", "K1-init", "K3", "K2", "K2-init",
                                  "K3-gather"])
def test_sweep_forms_match_reference_kernels(parts, gvar, form, op, out16):
    """Each sweep form on bf16 operands (packed: bf16 deltas and weights;
    gather: bf16 weights) with an f32 or bf16 output (and init), against
    the reference's kernel at one shard; K3's bf16 push bitwise."""
    import jax.numpy as jnp
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks as jax_sweep
    from cfd_proxy_tpu.ops.blocksweep import sweep_blocks_overlap

    packed = not form.startswith("K2") and form != "K3-gather"
    cls = "bulk" if form in ("K1", "K2") else "interior"
    kw = {"meta_dtype": BF} | ({"src_dtype": BF} if packed else {})
    jm = GreenGaussPallas(parts[1], NVAR, bp=BP, interpret=True, op=op,
                          kernel="packed" if packed else "gather",
                          force_rdma=True, **kw)
    js = jm.distribute_state(gvar, schedules=["bulk" if cls == "bulk"
                                              else "overlap"])
    ep, ks, nb = jm._dims[cls]
    odt = jnp.bfloat16 if out16 else jnp.float32
    rows = bs.out_rows(op)
    rng = np.random.default_rng(5)
    init = rng.standard_normal((1, rows, jm.layout.ndev)).astype(np.float32)
    send = rng.standard_normal((1, 2, rows, jm.layout.s_max)).astype(
        np.float32)
    tbl_key = "srcs" if packed else "exts"
    plan = jm._plans_dev[cls]
    common = dict(bp=jm.bp, ep=ep, kslots=ks, nblocks=nb, interpret=True,
                  op=op, packed=packed, src_format=jm.src_format,
                  wks=jm._wks[cls], out_dtype=odt)
    if form.startswith("K3"):
        keys = list(plan)
        dsts = np.zeros((1, 2), np.int32)

        def body(v, tbl, ini, sb, d, s, *pl):
            pa = {k: x[0] for k, x in zip(keys, pl)}
            pa[tbl_key] = tbl[0]
            g, r = sweep_blocks_overlap(v[0], pa, init=ini[0],
                                        sendbufs=sb[0], dsts=d[0],
                                        srcs=s[0], **common)
            return g[None], r[None]

        ref, r_ref = _jax_shard_call(
            body, 6 + len(keys), js["var_T"], js[f"tbl_{cls}"],
            jnp.asarray(init).astype(odt),
            jnp.asarray(send).astype(jnp.bfloat16), jnp.asarray(dsts),
            jnp.asarray(dsts), *plan.values())
    else:
        pa = {k: jnp.asarray(np.asarray(x)[0]) for k, x in plan.items()}
        pa[tbl_key] = jnp.asarray(np.asarray(js[f"tbl_{cls}"])[0])
        ini = (jnp.asarray(init[0]).astype(odt) if form.endswith("init")
               else None)
        ref = np.asarray(jax_sweep(jnp.asarray(state_from_jax(js)[0]), pa,
                                   init=ini, **common))[None]
    # the port, on the same plan arrays, its own bf16 casts of init/send
    arrays = plans_from_jax(jm)
    ca = arrays["classes"][cls]
    var_T = _t(state_from_jax(js))
    tbl = _t(np.asarray(js[f"tbl_{cls}"]))
    if tbl.dim() == 5:
        tbl = torch.cat(tbl.unbind(2), -1).contiguous()
    sweep_args = ((var_T, tbl, ca["slot_w"]) if packed else
                  (var_T, tbl, _t(ca["slot_idx"]), ca["slot_w"]))
    sweep_args += (_t(ca["scale"]), _t(ca["block_ids"]),
                   _t(bs.slot_table(ca["wks"])))
    tdt = torch.bfloat16 if out16 else torch.float32
    tinit = torch.from_numpy(init).to(tdt)
    if form.startswith("K3"):
        fused = (bs.sweep_blocks_overlap if packed
                 else bs.sweep_blocks_overlap_gather)
        dsts = torch.zeros((1, 2), dtype=torch.int32)
        got, r = fused(*sweep_args, tinit, torch.from_numpy(send).to(
            torch.bfloat16), dsts, dsts, op=op)
        np.testing.assert_array_equal(_bits(r), r_ref.view(np.uint16))
    else:
        sweep = bs.sweep_blocks if packed else bs.sweep_blocks_gather
        got = (sweep(*sweep_args, init=tinit, op=op)
               if form.endswith("init")
               else sweep(*sweep_args, op=op, out_dtype=tdt))
    _assert_close(got, ref, form)


# ------------------------------------------------------------- models

@pytest.mark.parametrize("P,kernel,option", MODEL_CASES)
def test_model_matches_reference_and_golden(parts, gvar, gref, jax_models, P,
                                            kernel, option):
    """Every schedule of the port's model against the reference model
    (raw device arrays, the sweep bounds) and against the golden inside the
    reference's band; schedules agree within the reference's cross bound."""
    jm, _, ref = jax_models(P, kernel, option)
    tm = GreenGaussTorch(parts[P], NVAR, bp=BP, kernel=kernel, device="cpu",
                         force_rdma=P == 1, **_options(kernel, option))
    st = tm.distribute_state(gvar)
    lo, hi = BANDS[option]
    denom = max(1.0, np.abs(gref).max())
    outs = {}
    for s in SCHEDULES:
        outs[s] = g = tm.step(st, s)
        assert g.dtype == tm.grad_t
        _assert_close(g, ref[s], s)
        err = np.abs(tm.gather_global(g) - gref).max() / denom
        assert lo < err < hi, (s, err)
    scale = float(outs["bulk"].float().abs().max())
    for a, b in (("early", "bulk"), ("overlap", "early")):
        d = float((outs[a].float() - outs[b].float()).abs().max())
        assert d <= CROSS[option] * scale, (a, b, d)


def _ghost_pairs(model):
    """(shard, ghost columns, owner shard, owner columns) of every comm
    entry with data."""
    out = []
    for i, p in enumerate(model.parts):
        for e in p.comm:
            q = model.parts[e.partner]
            back = [x for x in q.comm
                    if x.partner == p.part_id and x.round == e.round]
            send = model.locmap[e.partner][back[0].sendidx]
            if len(send):
                out.append((i, model.locmap[i][e.recvidx], e.partner, send))
    return out


@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_bf16_halo_owned_bitwise_ghosts_rounded(parts, gvar, kernel):
    """halo_dtype alone: owned columns bitwise those of the f32 model (they
    never ride the wire); every ghost column is the bf16 rounding (to
    nearest even) of its owner's column, bitwise — a send point's boundary
    sum is its whole sum, so the wire carries the owner's final value.
    With bf16 gradient stores as well, ghosts equal their owners."""
    f32 = GreenGaussTorch(parts[4], NVAR, bp=BP, kernel=kernel, device="cpu")
    halo = GreenGaussTorch(parts[4], NVAR, bp=BP, kernel=kernel,
                           device="cpu", halo_dtype=BF)
    both = GreenGaussTorch(parts[4], NVAR, bp=BP, kernel=kernel,
                           device="cpu", halo_dtype=BF, grad_dtype=BF)
    s32, sh, sb = (m.distribute_state(gvar) for m in (f32, halo, both))
    pairs = _ghost_pairs(halo)
    assert pairs
    for s in SCHEDULES:
        g32, gh, gb = f32.step(s32, s), halo.step(sh, s), both.step(sb, s)
        assert gh.dtype == torch.float32 and gb.dtype == torch.bfloat16
        for i, p in enumerate(halo.parts):
            assert torch.equal(gh[i, :, : p.nowned], g32[i, :, : p.nowned])
        assert not torch.equal(gh, g32)                 # the cast happened
        for i, ghost, q, own in pairs:
            assert torch.equal(gh[i][:, ghost],
                               gh[q][:, own].to(torch.bfloat16).float()), s
            assert torch.equal(gb[i][:, ghost], gb[q][:, own]), s


def test_flux_bf16_sources_and_stores(parts, gvar, jax_models):
    """The flux model with bf16 sources and gradient stores: against the
    reference's flux model (one bf16 ulp) and within the reference's 5e-3
    of the f32 flux model, every schedule."""
    from cfd_proxy_tpu_torch.models.gradients import PSDFluxModel

    kw = {"src_dtype": BF, "grad_dtype": BF}
    jm = GreenGaussPallas(parts[4], NVAR, bp=BP, interpret=True, op="flux",
                          **kw)
    js = jm.distribute_state(gvar)
    tm = PSDFluxModel(parts[4], NVAR, bp=BP, device="cpu", **kw)
    t32 = PSDFluxModel(parts[4], NVAR, bp=BP, device="cpu")
    st, s32 = tm.distribute_state(gvar), t32.distribute_state(gvar)
    scale = float(t32.step(s32, "bulk").abs().max())
    for s in SCHEDULES:
        g = tm.step(st, s)
        assert g.dtype == torch.bfloat16 and g.shape[1] == 8
        _assert_close(g, np.asarray(jm.step(js, s)), s)
        err = float((g.float() - t32.step(s32, s)).abs().max()) / scale
        assert 0 < err < 5e-3, (s, err)


def test_solver_mode_full_stack_matches_reference(parts, gvar, jax_models):
    """The solver-mode runner on the full stack (P=4, packed, 2 sweeps per
    step): the port's runner equals its manual step/update/refresh chain
    bitwise and the reference's runner within 1e-6; the var exchange stays
    f32."""
    jm, js, _ = jax_models(4, "packed", "full")
    tm = GreenGaussTorch(parts[4], NVAR, bp=BP, device="cpu", **FULL)
    st = tm.distribute_state(gvar)
    got = tm.iterate_fn("bulk", 2, solver_mode=True, sweeps_per_step=2)(
        *tm.iter_args(st))
    assert got.dtype == torch.float32
    v, tables = st["var_T"], st["tables"]
    for _ in range(2):
        for _ in range(2):
            g = tm.step({"var_T": v, "tables": tables}, "bulk")
            assert g.dtype == torch.bfloat16
            v = v + 1e-30 * g[:, :8]
        nxt = tm.refresh_state(v)
        v, tables = nxt["var_T"], nxt["tables"]
    assert torch.equal(got, v)
    want = np.asarray(jm.iterate_fn("bulk", 2, solver_mode=True,
                                    sweeps_per_step=2)(*jm.iter_args(js)))
    assert want.dtype == np.float32
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() / scale < PORT_TOL


@pytest.mark.parametrize("kernel", ["packed", "gather"])
def test_plans_from_jax_carries_bf16_weights(parts, gvar, jax_models,
                                             kernel):
    """A JAX model built with meta_dtype="bfloat16" converts: its weights
    cross bit for bit as a torch bf16 tensor, and the port built from the
    arrays computes exactly what it computes from its own host layer; an
    f32-weight port refuses them."""
    jm, _, _ = jax_models(4, kernel, "meta")
    arrays = plans_from_jax(jm)
    for c, ca in arrays["classes"].items():
        assert ca["slot_w"].dtype == torch.bfloat16
        want = np.asarray(jm._plans_dev[c]["slot_w"])
        np.testing.assert_array_equal(_bits(ca["slot_w"]),
                                      want.view(np.uint16), err_msg=c)
    conv = GreenGaussTorch.from_arrays(jm.parts, NVAR, arrays, device="cpu",
                                       meta_dtype=BF)
    own = GreenGaussTorch(parts[4], NVAR, bp=BP, kernel=kernel,
                          device="cpu", meta_dtype=BF)
    sc, so = conv.distribute_state(gvar), own.distribute_state(gvar)
    for s in SCHEDULES:
        assert torch.equal(conv.step(sc, s), own.step(so, s)), s
    with pytest.raises(CheckError, match="meta_dtype='bfloat16'"):
        GreenGaussTorch.from_arrays(jm.parts, NVAR, arrays, device="cpu")


# ------------------------------------------------------------ refusals

def test_bf16_sources_refused_with_gather_kernel(parts):
    with pytest.raises(CheckError, match="packed"):
        GreenGaussTorch(parts[1], NVAR, bp=BP, kernel="gather",
                        device="cpu", src_dtype=BF)
    # the CLI's solver-mode default is the gather kernel: the model's error
    with pytest.raises(CheckError, match="requires the packed kernel"):
        solver.main(["--nx", "6", "--ny", "5", "--nz", "4", "--device",
                     "cpu", "--iters", "2", "--solver-mode", "--src-dtype",
                     BF])


@pytest.mark.parametrize("name,call", [
    ("init dtype vs out_dtype", lambda a: bs.sweep_blocks(
        *a["sweep"], init=a["init"], out_dtype=torch.bfloat16)),
    ("f16 weights", lambda a: bs.sweep_blocks(
        a["sweep"][0], a["sweep"][1], a["sweep"][2].half(), *a["sweep"][3:])),
    ("bf16 exts", lambda a: bs.sweep_blocks_gather(
        a["gather"][0], a["gather"][1].bfloat16(), *a["gather"][2:])),
    ("f16 out_dtype", lambda a: bs.sweep_blocks(*a["sweep"],
                                                out_dtype=torch.float16)),
    ("bf16 var_T", lambda a: bs.sweep_blocks(a["sweep"][0].bfloat16(),
                                             *a["sweep"][1:])),
    ("bf16d without block_ids", lambda a: bs.pack_srcs(
        a["sweep"][0], a["cols"], src_format="bf16d")),
    ("unknown src_format", lambda a: bs.pack_srcs(
        a["sweep"][0], a["cols"], src_format="bf16")),
    ("bf16 push rows of 8 bytes", lambda a: bs.sweep_blocks_overlap(
        *a["sweep"], a["init"], a["send"][..., :4].contiguous().bfloat16(),
        a["dsts"], a["dsts"])),
])
def test_wrappers_refuse_other_precisions(parts, gvar, name, call):
    """Every dtype a kernel does not take raises by name, before any
    launch."""
    tm = GreenGaussTorch(parts[1], NVAR, bp=BP, device="cpu",
                         force_rdma=True)
    gm = GreenGaussTorch(parts[1], NVAR, bp=BP, kernel="gather",
                         device="cpu")
    st, sg = tm.distribute_state(gvar), gm.distribute_state(gvar)
    a = {"sweep": (st["var_T"], *tm._operands("bulk", st["tables"])),
         "gather": (sg["var_T"], *gm._operands("bulk", sg["tables"])),
         "cols": tm.plans["bulk"]["src_cols"],
         "init": torch.zeros((1, 24, tm.ndev)),
         "send": torch.zeros((1, tm.nphases, 24, tm.s_max)),
         "dsts": torch.zeros((1, tm.nphases), dtype=torch.int32)}
    with pytest.raises(CheckError):
        call(a)


def test_cli_full_stack(capsys):
    """The CLI at the acceptance command's size with all four options:
    every schedule runs, the result names the options, and bulk lands in
    the full-stack band."""
    rc = solver.main(["--nx", "8", "--ny", "8", "--nz", "8", "--parts", "4",
                      "--device", "cpu", "--iters", "2", "--json",
                      "--src-dtype", BF, "--meta-dtype", BF,
                      "--grad-dtype", BF, "--halo-dtype", BF])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(res[k] == BF for k in FULL)
    assert sorted(res["schedules"]) == ["bulk", "early", "overlap"]
    v = res["verification"]
    assert 1e-5 < v["bulk_vs_golden_relmax"] < 2e-2
