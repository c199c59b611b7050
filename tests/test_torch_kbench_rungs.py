"""The kernel bench's rungs on the prefix tables — var16 (K1 on a bf16
state), compact_i8 (K5d), bso_fold and bso_wsum (K5f), bso_acc3 (K5g),
cflux_fact (K5h), cstream_flux (K5i) — against the JAX kbench, on the CPU.

The rig is tests/test_torch_kbench.py's (`capture_jax_kernels`): one JAX
kbench run per variant and block size in interpret mode under
`jax.disable_jit()`, with `pallas_call` wrapped to record the kernel's
concrete operands and output.  Per variant, at bp 128 (every prefix width
is bp) and bp 256 on the 6³ mesh (every width partial):

- the port's tables equal the JAX kbench's operands bit for bit: the state
  (f32, var16's bf16), the f32, bf16-delta and int8 source tables, the
  weights (the pre-halved bf16 ones too), `wsum` and `i8_scale`;
- the plain version on the port's tables matches the captured kernel
  output: f32 within 1e-6 × max|ref| (cstream_flux bitwise: nothing to
  contract), bf16 within one bf16 ulp plus 1e-6 × max|ref|.

Then: the `--check` fingerprints of the six checked rungs against the JAX
kbench's printed ones (cstream_flux runs unchecked): the f32 cflux_fact's
to 1e-6 relative, the bf16 rungs' (summed in f32 by the port, in bf16 by
the reference) to the f32 sum of the plain output and the reference's to
that sum rounded to bf16; compact_i8 and compact_bso print different
fingerprints;
bso_acc3's and bso_fold's plain outputs equal compact_bso's bit for bit;
the wrappers refuse operands of an instance they do not have.
"""

import numpy as np
import pytest
import torch
from test_torch_kbench import (NX, TOL, _compact, _fingerprints, _torch,
                               assert_fingerprints, capture_jax_kernels)

from cfd_proxy_tpu.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.ops import twins
from cfd_proxy_tpu_torch.tools import kbench
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

# variant: its kernel's name in the JAX kbench (var16 runs the production
# sweep's `kernel`; both _bso_kernel instances are `kern`)
RUNGS = {"var16": "kernel", "compact_i8": "i8_kernel", "bso_fold": "kern",
         "bso_wsum": "kern", "bso_acc3": "bso_acc3_kernel",
         "cflux_fact": "cflux_fact_kernel",
         "cstream_flux": "cstream_flux_kernel"}
BPS = (128, 256)
CHECKED = tuple(n for n in RUNGS if n != "cstream_flux")
# the sixth operand of the two kernels that take one
EXTRA = {"compact_i8": "i8_scale", "bso_wsum": "wsum"}


@pytest.fixture(scope="module")
def jax_kernels():
    """(variant, bp) → (captured inputs, captured output)."""
    return capture_jax_kernels({(n, bp): (n, k, bp)
                                for n, k in RUNGS.items() for bp in BPS})


@pytest.fixture(scope="module")
def benches():
    mesh = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=0)
    return {bp: kbench.make_benches(mesh, bp=bp, device="cpu") for bp in BPS}


def _variant(benches, bp, name):
    return kbench.variant_table(benches[bp], [name])[name]


@pytest.mark.parametrize("bp", BPS)
@pytest.mark.parametrize("name", list(RUNGS))
def test_rung_plain_matches_jax_kernel(jax_kernels, benches, name, bp):
    (bids, v, srcs, slot_w, scale, *tail), ref = jax_kernels[name, bp]
    fn, var_T, t = _variant(benches, bp, name)
    # the port's tables are the JAX kbench's operands, bit for bit
    want_v = _torch(v)[None]
    assert var_T.dtype == want_v.dtype and torch.equal(var_T, want_v)
    assert torch.equal(t["block_ids"], _torch(bids)[None])
    assert torch.equal(t["scale"], _torch(scale)[None])
    for key, a in (("srcs", srcs), ("slot_w", slot_w)):
        want = _compact(a)
        assert t[key].dtype == want.dtype, key
        assert torch.equal(t[key], want), key
    assert len(tail) == (name in EXTRA)
    if tail:
        want = _torch(tail[0])[None]
        assert t[EXTRA[name]].dtype == want.dtype == torch.float32
        assert torch.equal(t[EXTRA[name]], want)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    counters = {**twins.launch_counters(), **bs.launch_counters()}
    before = {k: getattr(f, a) for k, (f, a) in counters.items()}
    got = fn(var_T, t)[0]
    assert {k: getattr(f, a) for k, (f, a) in counters.items()} == before
    ref = _torch(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale_ref = float(ref.float().abs().max())
    assert scale_ref > 0
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        assert bool((err <= bs.bf16_ulp(ref) + TOL * scale_ref).all())
    else:
        assert float(err.max()) <= TOL * scale_ref
    if name == "cstream_flux":
        assert torch.equal(got, ref)


@pytest.mark.parametrize("bp", BPS)
def test_rung_fingerprints_match_jax(capsys, monkeypatch, benches, bp):
    """The --check lines of both benches on the checked rungs: every one OK
    within the reference's tolerance, the port's fingerprints as
    `assert_fingerprints` holds them (f32 sums: the bf16 rungs are told
    apart); cstream_flux runs, unchecked."""
    from cfd_proxy_tpu.tools import kbench as jax_kbench

    argv = ["--nx", str(NX), "--bp", str(bp), "--iters", "1", "--variants",
            ",".join(RUNGS), "--check"]
    monkeypatch.setattr(jax_kbench, "two_point_sampler",
                        lambda *a, **k: (lambda: 1.0))
    assert jax_kbench.main(argv) == 0
    want = _fingerprints(capsys.readouterr().out)
    assert kbench.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _fingerprints(out)
    assert sorted(got) == sorted(want) == sorted(CHECKED)
    assert_fingerprints(got, want, benches[bp])
    assert "cstream_flux" in out


@pytest.mark.parametrize("bp", BPS)
def test_check_tells_compact_i8_from_compact_bso(capsys, benches, bp):
    """--check sums in f32, so the int8 rung and K1-w16-d16-o16 print
    different fingerprints; each is its output's f32 abs-sum."""
    assert kbench.main(["--nx", str(NX), "--bp", str(bp), "--iters", "1",
                        "--variants", "compact_bso,compact_i8", "--check",
                        "--device", "cpu"]) == 0
    got = _fingerprints(capsys.readouterr().out)
    assert sorted(got) == ["compact_bso", "compact_i8"]
    assert got["compact_i8"] != got["compact_bso"]
    for n, x in got.items():
        fn, v, t = _variant(benches, bp, n)
        want = float(fn(v, t).float().abs().sum())
        assert abs(x - want) <= TOL * want, n


@pytest.mark.parametrize("bp", BPS)
@pytest.mark.parametrize("name", ["bso_acc3", "bso_fold"])
def test_rung_equals_compact_bso_bitwise(benches, name, bp):
    """Three accumulator sets add the same products in the same order, and
    w/2 ⊗ (2·own + δ) is w ⊗ (own + δ/2) scaled through by two, which is
    exact: both plain versions give compact_bso's output bit for bit."""
    fn, v, t = _variant(benches, bp, name)
    ref_fn, ref_v, ref_t = _variant(benches, bp, "compact_bso")
    got, want = fn(v, t), ref_fn(ref_v, ref_t)
    assert got.dtype == want.dtype == torch.bfloat16
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)
    if name == "bso_fold":      # no halved weight was lost to underflow
        assert torch.equal(t["slot_w"].float() * 2, ref_t["slot_w"].float())


def test_i8_table_is_well_formed(benches):
    """The int8 table: inactive lanes hold 0, every active (block, variable)
    row reaches ±127 somewhere, the step rebuilds the deltas to half a step."""
    b = benches[256][""]
    _, v, t = b.variant("compact_i8")
    q, step = t["srcs"], t["i8_scale"]
    w = b.slot_w("prefix", torch.float32)
    active = (w != 0).any(dim=2, keepdim=True)
    assert q.dtype == torch.int8 and not bool(q[~active.expand_as(q)].any())
    assert bool((step == step[..., :1]).all())
    d = b.srcs("prefix", "f32") - b._own("prefix", v)
    d = torch.where(active, d, torch.zeros_like(d))
    amax = q.abs().amax(dim=3)
    assert bool(((amax == 127) | (d.abs().amax(dim=3) == 0)).all())
    err = (q.float() * step[..., :1] - d).abs()
    assert bool((err <= 0.5 * step[..., :1] * (1 + 1e-6)).all())


@pytest.mark.parametrize("case", [
    "var16_f32_weights", "var16_f32_out", "var16_flux", "var16_init",
    "i8_no_scale", "i8_scale_shape", "i8_f32_sources", "wsum_shape",
    "wsum_without_hoist", "hoist_without_wsum", "fold_f32_tables",
    "flux_fact_bf16"])
def test_rung_wrappers_reject_bad_operands(benches, case):
    """A wrapper takes only the instances it has: K1 a bf16 state in its one
    form; the int8 rung int8 sources with their steps; the bf16 rungs bf16
    tables, wsum with hoist_own alone; the flux rungs f32."""
    BF = torch.bfloat16

    def ops(name):
        _, v, t = _variant(benches, 128, name)
        return v, [t["srcs"], t["slot_w"], t["scale"], t["block_ids"],
                   t["slots"]], t

    with pytest.raises(CheckError):
        if case.startswith("var16"):
            v, o, _ = ops("var16")
            if case == "var16_f32_weights":
                o[1] = o[1].float()
                bs.sweep_blocks(v, *o, out_dtype=BF)
            elif case == "var16_f32_out":
                bs.sweep_blocks(v, *o)
            elif case == "var16_flux":
                bs.sweep_blocks(v, *o, op="flux", out_dtype=BF)
            else:
                init = torch.zeros((1, 24, v.shape[2]), dtype=BF)
                bs.sweep_blocks(v, *o, init=init)
        elif case.startswith("i8"):
            v, o, t = ops("compact_i8")
            if case == "i8_no_scale":
                twins.i8_sweep(v, *o)
            elif case == "i8_scale_shape":
                twins.i8_sweep(v, *o, i8_scale=t["i8_scale"][..., :1]
                               .contiguous())
            else:
                o[0] = o[0].float()
                twins.i8_sweep(v, *o, i8_scale=t["i8_scale"])
        elif case == "flux_fact_bf16":
            v, o, _ = ops("compact_bso")
            twins.flux_fact_twin(v, *o)
        else:
            v, o, t = ops("bso_wsum")
            if case == "wsum_shape":
                twins.bso_twin(v, *o, wsum=t["wsum"][..., :64].contiguous(),
                               hoist_own=True)
            elif case == "wsum_without_hoist":
                twins.bso_twin(v, *o, wsum=t["wsum"])
            elif case == "hoist_without_wsum":
                twins.bso_twin(v, *o, hoist_own=True)
            else:
                o[0], o[1] = o[0].float(), o[1].float()
                twins.bso_twin(v, *o)


def test_var16_state_is_the_bf16_of_the_bench_state(benches):
    """var16 quantizes own only: its deltas are the f32 sources minus the
    f32 of the bf16 state, so they differ from compact_bso's deltas exactly
    where the state's rounding shows through the bf16 of the difference."""
    b = benches[256][""]
    _, vq, t = b.variant("var16")
    _, v, t_bso = b.variant("compact_bso")
    assert vq.dtype == torch.bfloat16 and torch.equal(vq, v.to(vq.dtype))
    want = (b.srcs("prefix", "f32") - b._own("prefix", vq.float())).to(
        torch.bfloat16)
    assert torch.equal(t["srcs"], want)
    assert not torch.equal(t["srcs"], t_bso["srcs"])
    assert np.array_equal(t["slot_w"].float().numpy(),
                          t_bso["slot_w"].float().numpy())


# ---------------------------- K5d's V-lane groups (csrc/kbench_rungs.cu)

THREADS, STAGES = 128, 4   # the int8 rung's CUDA block and its ring's slots


def i8_grouped(var_T, srcs, slot_w, scale, block_ids, slots, i8_scale,
               lanes=twins.I8_LANES):
    """i8_kernel's index arithmetic in plain torch (V = `lanes`).  CUDA block (entry
    g, chunk c), thread t: S = V/2 threads share a group of V lanes, thread
    t takes variables [h·NV/S, (h+1)·NV/S), h = t // G (G = 128/S groups a
    block), of lanes l0..l0+V-1, l0 = V·(c·G + t % G); a group is live in
    slot k when l0 < wks[k].  Its live slots' rows are copied into a ring
    of STAGES slots, STAGES - 1 ahead of the one computed: slot i of its
    sequence into stage i % STAGES, consumed from there before that stage
    is refilled.  Each copy reads V elements at its flat offset (int8
    deltas (g·NV + v)·L + off + l0, bf16 weights g·3·L + d·L + off + l0;
    own (p·NV + v)·ndev + col and scale g·bp + l0 loaded directly), every
    offset a multiple of V (the alignment the kernel needs); each lane's
    arithmetic is the kernel's, in its order."""
    P, nb, nv, L = srcs.shape
    ndev, bp = var_T.shape[2], scale.shape[-1]
    S = lanes // 2
    G, ns = THREADS // S, nv // S
    chunks = -(-bp // (G * lanes))
    j = torch.arange(lanes)
    fv, fq = var_T.reshape(-1), srcs.reshape(-1)
    fw, fs = slot_w.reshape(-1), scale.reshape(-1)
    widths, offs = slots.tolist()

    def vec(flat, start):
        assert bool((start % lanes == 0).all())        # aligned vector access
        return flat[start[:, None] + j].float()        # (groups, V)

    out = torch.zeros((P, 3 * nv, ndev), dtype=torch.bfloat16)
    t = torch.arange(THREADS)
    for p in range(P):
        for b in range(nb):
            g = p * nb + b
            if b > 0 and block_ids[p, b] == block_ids[p, b - 1]:
                continue                               # pad entry
            for c in range(chunks):
                l0 = lanes * (c * G + t % G)
                live_t = l0 < bp
                h, l0 = (t // G)[live_t], l0[live_t]
                # threads with one live-slot sequence run the same ring
                seqs = {}
                for i, x in enumerate(l0.tolist()):
                    key = tuple(k for k, w in enumerate(widths) if x < w)
                    seqs.setdefault(key, []).append(i)
                for seq, idx in seqs.items():
                    idx = torch.tensor(idx)
                    tl, th = l0[idx], h[idx]
                    col = int(block_ids[p, b]) * bp + tl
                    for u in range(ns):
                        v = th * ns + u                # (threads,)
                        own = vec(fv, (p * nv + v) * ndev + col)
                        step = i8_scale[p, b, v, 0].float()[:, None]
                        acc = torch.zeros((3, len(idx), lanes))
                        ring = [None] * STAGES
                        for i, k in enumerate(seq[:STAGES - 1]):
                            ring[i % STAGES] = k
                        for i, k in enumerate(seq):
                            assert ring[i % STAGES] == k  # not overwritten
                            off = offs[k]
                            q = vec(fq, (g * nv + v) * L + off + tl)
                            tv = own + 0.5 * (q * step)
                            for d in range(3):
                                w = vec(fw, g * 3 * L + d * L + off + tl)
                                acc[d] += w * tv
                            if i + STAGES - 1 < len(seq):  # refill, freed
                                ring[(i - 1) % STAGES] = seq[i + STAGES - 1]
                        sc = vec(fs, g * bp + tl)
                        res = (acc * sc).to(torch.bfloat16)
                        cols = (col[:, None] + j)
                        for d in range(3):
                            rows = d * nv + v
                            out[p, rows[:, None], cols] = res[d]
    return out


def _live_width_ends(t, lanes):
    """(entry, slot) pairs whose live width (their last lane with a nonzero
    weight, + 1) ends inside a V-lane group of the padded prefix."""
    ends = []
    widths, offs = t["slots"].tolist()
    w = t["slot_w"][0]                                  # (nb, 3, L)
    for k, (wk, off) in enumerate(zip(widths, offs)):
        nz = (w[:, :, off:off + wk] != 0).any(dim=1)   # (nb, wk)
        for b in range(nz.shape[0]):
            live = int(nz[b].nonzero().max()) + 1 if bool(nz[b].any()) else 0
            if live % lanes and live < wk:
                ends.append((b, k))
    return ends


@pytest.mark.parametrize("bp", BPS)
def test_i8_lane_groups_equal_plain_bitwise(benches, bp):
    """V point columns per thread, V/2 threads a group, live by the
    group's first lane, copied at V-aligned offsets through the ring: the
    plain version bit for bit, on the bench's tables at bp 128 and 256,
    entries whose live width ends inside a V-lane group of the padded
    prefix included (their pad lanes carry zero weights)."""
    fn, v, t = _variant(benches, bp, "compact_i8")
    assert _live_width_ends(t, twins.I8_LANES), "no live width ends mid-group"
    ops = (v, t["srcs"], t["slot_w"], t["scale"], t["block_ids"], t["slots"])
    want = twins.i8_sweep_ref(*ops, t["i8_scale"])
    got = i8_grouped(*ops, t["i8_scale"])
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)
    twins.check_i8_lanes(*ops[:4])                      # the tables pass
    widths, offs = t["slots"].tolist()                  # the kernel's trap
    assert not any(x % twins.I8_LANES for x in widths + offs)


def _i8_ops(benches):
    _, v, t = _variant(benches, 256, "compact_i8")
    return {"var_T": v, "srcs": t["srcs"], "slot_w": t["slot_w"],
            "scale": t["scale"]}


def _shifted(x):
    """x's values in a view one element past an aligned start."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("case", ["bp", "var_T", "scale", "slot_w", "srcs"])
def test_i8_lane_checks_raise(benches, case):
    """The int8 rung's wrapper raises before a launch on what its vector
    accesses cannot take: bp not a multiple of I8_LANES, an operand not
    aligned to them."""
    o = _i8_ops(benches)
    if case == "bp":
        o["scale"] = torch.zeros((1, 2, 1, 254))
    else:
        o[case] = _shifted(o[case])
    twins.check_i8_lanes(**_i8_ops(benches))
    with pytest.raises(CheckError, match="i8_sweep"):
        twins.check_i8_lanes(**o)
