"""The halo pack as one pass (`ops/halo_pack.py`, csrc/halo_pack.cu).

On the CPU:

- `pack_halo_ref` is the models' pack as it was written before the kernel,
  `(x[shard, row, cols] * scale).to(wire)` over broadcast int64 shard, row
  and column indices, bit for bit: f32 and bf16 x, f32 and bf16 wire, 24
  and 8 rows, `send_mask` and `pack_scale`, the P ∈ {3, 8} plans of a small
  mesh; its wrapper on CPU tensors runs it and counts nothing;
- the wrapper refuses an operand of the wrong dtype, shape or device, a
  non-contiguous one, lanes that are not whole quads (s_max not a multiple
  of 4, or off the 16-byte boundary) and a wire dtype it does not write;
- the models' steps at P ∈ {3, 8} (every schedule, packed and gather, gg
  and flux, bf16 gradients and halo, solver mode) are bit for bit the
  steps with the old pack rebuilt here, and count the same `halo_bytes`
  and `halo_live_bytes`.

The `cuda`-marked tests hold the kernel bit for bit against its plain
version on the card (every form, plans' pads, ragged row groups,
non-finite sources) and read its registers; they import no JAX and skip
without a card:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_halo_pack.py -m cuda
"""

import numpy as np
import pytest
import torch

from cfd_proxy_tpu_torch.mesh.generator import generate_mesh, make_state
from cfd_proxy_tpu_torch.mesh.partition import partition_mesh
from cfd_proxy_tpu_torch.models import compiled
from cfd_proxy_tpu_torch.models.gradients import (GreenGaussTorch,
                                                  PSDFluxModel, halo_counters)
from cfd_proxy_tpu_torch.ops import halo_pack
from cfd_proxy_tpu_torch.ops.halo_pack import pack_halo, pack_halo_ref
from cfd_proxy_tpu_torch.ops.plan import NV
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

NVAR = 5
BP = 128
C = 0.1              # a coupling that makes the state carry the gradients
STEPS = 2
SCHEDULES = ("bulk", "early", "overlap", "nocomm")
F32, BF16 = torch.float32, torch.bfloat16
BF = "bfloat16"


def bits(t: torch.Tensor) -> np.ndarray:
    """The bit patterns of an f32 or bf16 tensor."""
    t = t.detach().contiguous().cpu()
    return (t.view(torch.int16) if t.dtype == BF16
            else t.view(torch.int32)).numpy()


def old_pack(model, x, scale, wire=F32):
    """The models' `_pack` before the kernel: the advanced index over the
    model's broadcast shard, row and int64 column indices, the product and
    the cast, then the counts."""
    n = model.nlocal
    shard = torch.arange(n, device=model.device).view(n, 1, 1, 1)
    row = torch.arange(3 * NV, device=model.device).view(1, 1, 3 * NV, 1)
    cols = model.pack_cols.long()
    bufs = (x[shard, row[:, :, : x.shape[1]], cols] * scale).to(wire)
    size = bufs.element_size()
    count = GreenGaussTorch._pack
    count.halo_bytes += bufs.numel() * size
    count.halo_live_bytes += model.live_cols * x.shape[1] * size
    return bufs


class _OldPack:
    """The model with its pack as it was before the kernel."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        m = self.model
        m._pack = lambda x, scale, wire=F32: old_pack(m, x, scale, wire)
        return m

    def __exit__(self, *exc):
        del self.model._pack        # back to the class's method


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                         seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def models(mesh):
    cache = {}

    def get(op, npart, kernel="packed", **opts):
        key = (op, npart, kernel, tuple(sorted(opts.items())))
        if key not in cache:
            cls = GreenGaussTorch if op == "gg" else PSDFluxModel
            cache[key] = cls(partition_mesh(mesh, npart), NVAR, bp=BP,
                             kernel=kernel, device="cpu", **opts)
        return cache[key]

    return get


def _x(model, rows, dtype, seed=5):
    """A (P, rows, ndev) source with negative values and exact zeros, so
    the sign of a zero product shows in the bits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((model.nlocal, rows, model.ndev)) * 3
    x[rng.random(x.shape) < 0.1] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _counts():
    return {k: getattr(fn, a)
            for k, (fn, a) in halo_pack.launch_counters().items()}


REF_CASES = [pytest.param(P, rows, xd, wire, sc,
                          id=f"P{P}-rows{rows}-x{str(xd)[6:]}-"
                             f"{str(wire)[6:]}-{sc}")
             for P in (3, 8) for rows in (3 * NV, NV)
             for xd in (F32, BF16) for wire in (F32, BF16)
             for sc in ("send_mask", "pack_scale")]


@pytest.mark.parametrize("P,rows,x_dtype,wire,scale", REF_CASES)
def test_plain_version_is_the_old_pack(models, P, rows, x_dtype, wire,
                                       scale):
    m = models("gg", P)
    assert m.moves and m.pack_cols.dtype == torch.int32
    x = _x(m, rows, x_dtype, seed=P * rows)
    sc = getattr(m, scale)
    want = old_pack(m, x, sc, wire)
    before = _counts()
    for fn in (pack_halo_ref, pack_halo):
        got = fn(x, m.pack_cols, sc, wire)
        assert got.dtype == wire
        assert got.shape == (P, m.nphases, rows, m.s_max)
        assert np.array_equal(bits(got), bits(want))
    # on CPU tensors the wrapper is the plain version and launches nothing
    assert _counts() == before
    # pads (scale 0) are there, and their products keep the sign of zero
    dead = (sc == 0).expand_as(want)
    assert dead.any() and not dead.all()
    assert (want.float()[dead] == 0).all()


def test_wrapper_refuses_bad_operands(models):
    m = models("gg", 3)
    x = _x(m, 3 * NV, F32)
    idx, sc = m.pack_cols, m.pack_scale
    wide = idx.shape[:3] + (idx.shape[3] + 1,)
    idx_nc = torch.zeros(wide, dtype=torch.int32)[..., 1:]
    sc_nc = torch.zeros(wide)[..., 1:]
    assert idx_nc.shape == idx.shape and not idx_nc.is_contiguous()
    # contiguous, but a lane off the 16-byte boundary
    idx_off = torch.zeros(idx.numel() + 1, dtype=torch.int32)[1:].view(
        idx.shape)
    sc_off = torch.zeros(sc.numel() + 1)[1:].view(sc.shape)
    assert idx_off.is_contiguous() and idx_off.data_ptr() % 16 != 0
    bad = {
        "x must be": [(x.double(), idx, sc, F32), (x[0], idx, sc, F32),
                      (x.transpose(1, 2).contiguous().transpose(1, 2),
                       idx, sc, F32)],
        "idx must be": [(x, idx.long(), sc, F32), (x, idx[:2], sc, F32),
                        (x, idx[:, :, 0], sc, F32),
                        (x, idx.expand(-1, -1, 2, -1), sc, F32),
                        (x, idx_nc, sc, F32), (x, idx.to("meta"), sc, F32)],
        "scale must be": [(x, idx, sc.double(), F32),
                          (x, idx, sc[:, :1], F32), (x, idx, sc_nc, F32),
                          (x, idx, sc.to("meta"), F32)],
        "whole quads": [(x, idx_off, sc, F32), (x, idx, sc_off, F32),
                        (x, idx[..., :-1].contiguous(),
                         sc[..., :-1].contiguous(), F32)],
        "wire dtype": [(x, idx, sc, torch.float16)],
        "unsupported device": [(x.to("meta"), idx.to("meta"),
                                sc.to("meta"), F32)],
    }
    for match, cases in bad.items():
        for args in cases:
            with pytest.raises(CheckError, match=match):
                pack_halo(*args)
    with pytest.raises(CheckError, match="takes tensors"):
        pack_halo(x.numpy(), idx, sc)


# ----------------------------------- the models' steps, as they were

STEP_CASES = [pytest.param("gg", P, k, {}, id=f"gg-P{P}-{k}")
              for P in (3, 8) for k in ("packed", "gather")]
STEP_CASES += [pytest.param("flux", P, k, {}, id=f"flux-P{P}-{k}")
               for P, k in ((3, "packed"), (8, "gather"))]
STEP_CASES += [pytest.param("gg", 3, "packed", o, id=f"gg-P3-{tag}")
               for tag, o in (("g16", {"grad_dtype": BF}),
                              ("h16", {"halo_dtype": BF}),
                              ("g16-h16", {"grad_dtype": BF,
                                           "halo_dtype": BF}))]


@pytest.mark.parametrize("op,npart,kernel,opts", STEP_CASES)
def test_steps_equal_the_old_pack(models, gvar, op, npart, kernel, opts):
    tm = models(op, npart, kernel, **opts)
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    for s in SCHEDULES:
        c0 = compiled.counts()
        got = tm.step(st, s)
        c1 = compiled.counts()
        with _OldPack(tm):
            want = tm.step(st, s)
        c2 = compiled.counts()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(bits(got), bits(want)), s
        for k in halo_counters():
            assert c1[k] - c0[k] == c2[k] - c1[k], (s, k)
        moved = c1["halo_bytes"] - c0["halo_bytes"]
        assert (moved > 0) == (s != "nocomm"), s
    # and chained: the state after STEPS steps of each schedule
    for s in SCHEDULES:
        got = tm.iterate_fn(s, STEPS, coupling=C)(*tm.iter_args(st))
        v = var0
        with _OldPack(tm) as m:
            for _ in range(STEPS):
                v = torch.add(v, C * m(v, st["tables"], s)[:, :NV])
        assert (got - var0).abs().max() > 1e-3
        assert np.array_equal(bits(got), bits(v)), s


@pytest.mark.parametrize("npart,kernel,schedule", [
    pytest.param(3, "gather", "early", id="P3-gather-early"),
    pytest.param(8, "packed", "overlap", id="P8-packed-overlap"),
    pytest.param(8, "gather", "bulk", id="P8-gather-bulk")])
def test_solver_mode_equals_the_old_pack(models, gvar, npart, kernel,
                                         schedule):
    """Solver mode: the rebuild, the sweep with its exchange, the update,
    then the var exchange, whose pack moves the f32 state's NV rows by
    send_mask."""
    tm = models("gg", npart, kernel)
    st = tm.distribute_state(gvar)
    var0 = st["var_T"].clone()
    c0 = compiled.counts()
    got = tm.iterate_fn(schedule, STEPS, solver_mode=True, coupling=C)(
        *tm.iter_args(st))
    c1 = compiled.counts()
    with _OldPack(tm):
        want = tm.iterate_fn(schedule, STEPS, solver_mode=True,
                             coupling=C)(*tm.iter_args(st))
    c2 = compiled.counts()
    assert (got - var0).abs().max() > 1e-3
    assert np.array_equal(bits(got), bits(want))
    for k in halo_counters():
        assert c1[k] - c0[k] == c2[k] - c1[k] > 0, k


def test_var_exchange_equals_the_old_pack(models, gvar):
    """The var exchange alone, in place, on a state whose ghost columns are
    stale: the new pack fills them as the old one did."""
    tm = models("gg", 8)
    st = tm.distribute_state(gvar)
    stale = st["var_T"] * 1.5
    stale[:, :, tm.ghost_start:] = 0.0
    got = tm._var_exchange(stale.clone())
    with _OldPack(tm):
        want = tm._var_exchange(stale.clone())
    assert not torch.equal(got, stale)
    assert np.array_equal(bits(got), bits(want))


# ------------------------------------------------------------ on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


FORMS = [pytest.param(xd, w, id=f"x{str(xd)[6:]}-{str(w)[6:]}")
         for xd in (F32, BF16) for w in (F32, BF16)]


def _check_form(x, idx, sc, wire):
    """The kernel against the plain version on the card: every lane bit for
    bit (NaN where the plain version has NaN), one launch of its form."""
    attr = halo_pack.COUNT_ATTRS[x.dtype == BF16, wire == BF16]
    before = getattr(pack_halo, attr)
    got = pack_halo(x, idx, sc, wire)
    want = pack_halo_ref(x, idx, sc, wire)
    torch.cuda.synchronize()
    assert getattr(pack_halo, attr) == before + 1
    assert got.dtype == wire and got.shape == want.shape
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert np.array_equal(bits(got)[~nan.cpu().numpy()],
                          bits(want)[~nan.cpu().numpy()])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,wire", FORMS)
@pytest.mark.parametrize("P", [3, 8])
def test_cuda_pack_equals_plain_on_a_plan(mesh, P, x_dtype, wire):
    """A plan's send columns, pads and scales, 24 and 8 rows, both scales."""
    _cuda()
    m = GreenGaussTorch(partition_mesh(mesh, P), NVAR, bp=BP, device="cuda")
    for rows in (3 * NV, NV):
        x = _x(m, rows, x_dtype, seed=rows).cuda()
        for sc in (m.send_mask, m.pack_scale):
            got = _check_form(x, m.pack_cols, sc, wire)
            dead = (sc == 0).expand_as(got)
            assert dead.any() and (got.float()[dead] == 0).all()
    m.close()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,wire", FORMS)
@pytest.mark.parametrize("P,rows,ndev,nph,s_max", [
    (3, 24, 1001, 5, 64),      # rows a multiple of the kernel's group of 4
    (2, 7, 517, 3, 12),        # a ragged row group
    (1, 8, 33, 1, 4)])         # one quad of lanes
def test_cuda_pack_equals_plain_synthetic(P, rows, ndev, nph, s_max, x_dtype,
                                          wire):
    """Random columns and scales with zeros, sources with infinities and
    NaN, an odd ndev (x's rows off the 16-byte boundary)."""
    _cuda()
    gen = torch.Generator("cuda").manual_seed(ndev + s_max)
    x = torch.randn((P, rows, ndev), device="cuda", generator=gen) * 5
    flat = x.view(-1)
    flat[:: 97] = float("inf")
    flat[5:: 89] = float("-inf")
    flat[11:: 83] = float("nan")
    x = x.to(x_dtype)
    idx = torch.randint(0, ndev, (P, nph, 1, s_max), device="cuda",
                        generator=gen, dtype=torch.int32)
    sc = torch.rand((P, nph, 1, s_max), device="cuda", generator=gen) - 0.3
    sc[sc < 0] = 0.0
    _check_form(x, idx, sc, wire)


@pytest.mark.cuda
def test_cuda_pack_registers():
    """Every instance: no local memory (no spills), at least four blocks
    of 256 threads resident an SM."""
    _cuda()
    from cfd_proxy_tpu_torch.ops import _cuda as cu

    for x16 in (0, 1):
        for o16 in (0, 1):
            f = cu.kernel_info("cfd_pack_halo_info", x16, o16)
            assert f["local_bytes"] == 0 and 0 < f["regs"] <= 64, f
            assert f["blocks_per_sm"] >= 4, f
