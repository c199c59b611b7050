"""The port's kernel bench (`cfd_proxy_tpu_torch.tools.kbench`) and its
twins (ops/twins.py) against the JAX kbench, on the CPU.

The JAX kbench's Pallas twin kernels are closures inside its `main()`, so
they cannot be imported: each JAX run here wraps
`jax.experimental.pallas.pallas_call` (pytest's monkeypatch) so that every
call records its concrete inputs and output by kernel name, and runs
`cfd_proxy_tpu.tools.kbench.main` on one variant under `jax.disable_jit()`
in interpret mode (one variant per run: cstream_c and cstream_bso share the
kernel name).  Then:

- the port's tables for that variant equal the JAX kbench's inputs (the
  state, scale and block ids; the f32 tables and the bf16 delta tables
  bit for bit, the rectangular ones in the compact layout at full widths);
- each twin's plain version on those inputs matches the JAX kernel's
  output: f32 within 1e-6 × max|ref| (the stream twins bitwise: no
  multiply-add to contract), the bf16 output within one bf16 ulp plus
  1e-6 × max|ref|.  bp 128 makes every prefix width bp; bp 256 on the
  6³ mesh makes every width 128 < bp, the partial-width branch that runs
  at bp 4096 on the card;
- the port's `--check` fingerprints equal the JAX kbench's printed ones to
  1e-6 relative, for the K1 variants and nv7 with an f32 output; with a
  bf16 output the port sums in f32 (the reference in bf16, an 8-bit
  number), so its fingerprint is held to the f32 sum of the plain
  version's output and the reference's to that sum rounded to bf16;
- `--paired` reports the median ratio; no variant of the reference's table
  is refused (`REFUSED` is empty), unknown names are.

The rungs on the prefix tables (var16, compact_i8, bso_*, cflux_fact,
cstream_flux) are held the same way in tests/test_torch_kbench_rungs.py,
through `capture_jax_kernels` here.
"""

import re

import numpy as np
import pytest
import torch

from cfd_proxy_tpu.mesh.generator import generate_mesh
from cfd_proxy_tpu_torch.ops import blocksweep as bs
from cfd_proxy_tpu_torch.tools import kbench
from cfd_proxy_tpu_torch.utils.errors import CheckError

torch.set_num_threads(1)

TOL = 1e-6
NX = 6
# variant: (kernel name in the JAX kbench, block size)
TWINS = {"stream": ("stream_kernel", 128), "wsum": ("wsum_kernel", 128),
         "nv7": ("nv7_kernel", 128),
         "cstream_c": ("cstream_bso_kernel", 256),
         "cstream_bso": ("cstream_bso_kernel", 256)}
# the check fingerprints, per block size: the full-width variants at 128
# and the prefix ones at 256 (partial widths)
CHECKED = {128: ("prod", "flat", "bf16src", "w16", "bf16sw", "nv7"),
           256: ("compact", "compact_bsw", "compact_bso", "cflux")}
CHECK_LINE = re.compile(r"check (\w+): \|g\|sum device (\S+) vs golden "
                        r"(\S+) rel \S+ -> (OK|FAIL)")


def _torch(a) -> torch.Tensor:
    """A host array from JAX as a tensor (bf16 through its bits)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _compact(a) -> torch.Tensor:
    """(nb, K, R, bp) rectangular table → (1, nb, R, K·bp), the compact
    layout at full widths; a compact (nb, R, L) table → (1, nb, R, L)."""
    t = _torch(a)
    if t.dim() == 4:
        t = torch.cat([t[:, k] for k in range(t.shape[1])], dim=-1)
    return t[None].contiguous()


def capture_jax_kernels(cases: dict) -> dict:
    """{key: (variant, kernel name, bp)} → {key: (captured inputs, captured
    output)} of that kernel's first call in a JAX kbench run on the variant
    alone (its state at the start of the chained loop).  Kernels of the
    same name in one run (the source pack's and the sweep's are both
    `kernel`) are told apart by their operand count: the sweeps and twins
    take five or six."""
    import jax
    from jax.experimental import pallas as pl

    from cfd_proxy_tpu.tools import kbench as jax_kbench

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        for key, (name, kernel, bp) in cases.items():
            seen = {}

            def recording(kern, *a, **kw):
                f = orig(kern, *a, **kw)

                def call(*args):
                    res = f(*args)
                    if len(args) >= 5:
                        seen.setdefault(getattr(kern, "__name__", ""),
                                        ([np.array(x) for x in args],
                                         np.array(res)))
                    return res

                return call

            mp.setattr(pl, "pallas_call", recording)
            with jax.disable_jit():
                rc = jax_kbench.main(["--nx", str(NX), "--bp", str(bp),
                                      "--iters", "1", "--variants", name])
            assert rc == 0
            out[key] = seen[kernel]
    return out


@pytest.fixture(scope="module")
def jax_kernels():
    """variant → (captured inputs, captured output) of its twin kernel."""
    return capture_jax_kernels({n: (n, *kb) for n, kb in TWINS.items()})


@pytest.fixture(scope="module")
def benches():
    mesh = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=0)
    return {bp: kbench.make_benches(mesh, bp=bp, device="cpu")
            for bp in (128, 256)}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_plain_matches_jax_kernel(jax_kernels, benches, name):
    (bids, v, srcs, slot_w, scale), ref = jax_kernels[name]
    fn, var_T, t = kbench.variant_table(benches[TWINS[name][1]],
                                        [name])[name]
    # the port's tables are the JAX kbench's inputs
    assert torch.equal(var_T, _torch(v)[None])
    assert torch.equal(t["block_ids"], _torch(bids)[None])
    assert torch.equal(t["scale"], _torch(scale)[None])
    assert torch.equal(t["srcs"], _compact(srcs))
    assert torch.equal(t["slot_w"], _compact(slot_w))
    # the wrapper on CPU tensors is the plain version, and launches nothing
    counters = kbench.twins.launch_counters()
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
    if name in ("stream", "cstream_c"):
        assert torch.equal(got, ref)


def _fingerprints(text: str) -> dict:
    out = {}
    for m in CHECK_LINE.finditer(text):
        assert m.group(4) == "OK", m.group(0)
        out[m.group(1)] = float(m.group(2))
    return out


def assert_fingerprints(got: dict, want: dict, bench) -> None:
    """The port's --check fingerprints against the JAX kbench's: an f32
    output's within 1e-6 relative of the JAX line; a bf16 output's, which
    the port sums in f32 and the reference in bf16 (an 8-bit number),
    within 1e-6 of the f32 abs-sum of the plain version's output (itself
    held to the JAX kernel by the plain-version tests), and the JAX line
    that f32 sum rounded to bf16: within half a bf16 ulp of it."""
    table = kbench.variant_table(bench, list(got))
    for n in got:
        fn, v, t = table[n]
        out = fn(v, t)
        if out.dtype == torch.bfloat16:
            f32 = float(out.float().abs().sum())
            assert abs(got[n] - f32) <= TOL * f32, n
            assert abs(want[n] - f32) <= (2.0 ** -8 + TOL) * f32, n
        else:
            assert abs(got[n] - want[n]) <= TOL * abs(want[n]), n


@pytest.mark.parametrize("bp", sorted(CHECKED))
def test_check_fingerprints_match_jax(capsys, monkeypatch, benches, bp):
    """The --check lines of both benches on the same variants: every one OK,
    the port's fingerprints as `assert_fingerprints` holds them (the JAX
    run's timing loop is stubbed out: its sampler returns at once)."""
    from cfd_proxy_tpu.tools import kbench as jax_kbench

    names = ",".join(CHECKED[bp])
    argv = ["--nx", str(NX), "--bp", str(bp), "--iters", "1", "--variants",
            names, "--check"]
    monkeypatch.setattr(jax_kbench, "two_point_sampler",
                        lambda *a, **k: (lambda: 1.0))
    assert jax_kbench.main(argv) == 0
    want = _fingerprints(capsys.readouterr().out)
    assert kbench.main(argv + ["--device", "cpu"]) == 0
    got = _fingerprints(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == sorted(CHECKED[bp])
    assert_fingerprints(got, want, benches[bp])


def test_twins_not_checked(capsys):
    """--check fingerprints the variants with gg or flux semantics only: the
    stream and wsum twins run, unchecked."""
    assert kbench.main(["--nx", str(NX), "--bp", "256", "--iters", "1",
                        "--variants", "stream,wsum,cstream_c,cstream_bso,"
                        "nv7", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert set(_fingerprints(out)) == {"nv7"}
    for n in ("stream", "wsum", "cstream_c", "cstream_bso"):
        assert re.search(rf"^{n}\s+(\S+ ms|below)", out, re.M), n


def _fixed_sampler(monkeypatch, times):
    """kbench's sampler replaced by one that hands the n-th variant asked
    for the n-th list of `times`, one per sample: the CPU's timings under
    a loaded test run can all fall below the two-point noise floor."""
    made = []

    def sampler(fn, v0, tables, iters):
        seq = iter(times[len(made)])
        made.append(fn)
        return lambda: next(seq)

    monkeypatch.setattr(kbench, "sampler", sampler)
    return made


PAIRED = ["--nx", str(NX), "--bp", "128", "--iters", "2", "--paired",
          "compact,cstream_c", "--repeats", "2", "--device", "cpu"]


def test_paired_reports_median_ratio(capsys, monkeypatch):
    """Turns a, b then b, a; the ratio of each pair, their median and IQR,
    and each variant's median time."""
    made = _fixed_sampler(monkeypatch, [[2e-3, 2.2e-3], [1e-3, 1e-3]])
    assert kbench.main(PAIRED) == 0
    out = capsys.readouterr().out
    assert len(made) == 2
    assert re.search(r"pair  0: compact +2\.000 ms +cstream_c +1\.000 ms +"
                     r"ratio 2\.0000", out), out
    assert re.search(r"pair  1: .* ratio 2\.2000", out), out
    assert ("paired compact/cstream_c: median ratio 2.1000  IQR "
            "[2.0500, 2.1500]  n=2") in out
    assert "compact: median 2.100 ms  cstream_c: median 1.000 ms" in out


def test_paired_all_samples_nonfinite(capsys, monkeypatch):
    """No finite pair: no ratio, rc 1 and the noise-floor message."""
    nan = float("nan")
    _fixed_sampler(monkeypatch, [[nan, 1e-3], [1e-3, nan]])
    assert kbench.main(PAIRED) == 1
    out = capsys.readouterr().out
    assert "paired: every sample below the dispatch-noise floor" in out
    assert "median ratio" not in out


def test_bp_alt_variants(capsys):
    assert kbench.main(["--nx", str(NX), "--bp", "128", "--bp-alt", "256",
                        "--iters", "1", "--variants",
                        "prod_alt,compact_bsw_alt", "--check",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "alt: bp=256" in out
    assert set(_fingerprints(out)) == {"prod_alt", "compact_bsw_alt"}


def test_unported_variants_refused_by_name():
    """No variant is left to refuse: every name of the reference's variant
    table (and its *_alt names) is one the port runs."""
    import inspect

    from cfd_proxy_tpu.tools import kbench as jax_kbench

    assert kbench.REFUSED == {}
    src = inspect.getsource(jax_kbench.main)
    table = src[src.index("    variants = {"):]
    names = set(re.findall(r'^        "(\w+)": \(', table[:table.index("}")],
                           re.M))
    alts = set(re.findall(r'variants\["(\w+)"\] = ', src))
    assert len(names) == 21 and "var16" in names and len(alts) == 4
    assert names == set(kbench.VARIANTS)
    assert alts == {a + "_alt" for a in kbench.ALT}
    kbench.check_names(sorted(names))
    kbench.check_names(sorted(alts), bp_alt=256)


def test_unknown_and_alt_without_bp_alt_refused():
    with pytest.raises(CheckError, match="unknown variant"):
        kbench.main(["--variants", "nope", "--device", "cpu"])
    with pytest.raises(CheckError, match="need --bp-alt"):
        kbench.main(["--variants", "prod_alt", "--device", "cpu"])


@pytest.mark.parametrize("case", ["mixed_dtypes", "wsum_bf16", "nv7_rows"])
def test_twin_wrappers_reject_bad_operands(benches, case):
    """A twin takes only the instances it has: the stream twin all f32 or
    all bf16, wsum f32, nv7 seven rows."""
    from cfd_proxy_tpu_torch.ops import twins

    _, v, t = kbench.variant_table(benches[128], ["stream"])["stream"]
    ops = (t["srcs"], t["slot_w"], t["scale"], t["block_ids"], t["slots"])
    with pytest.raises(CheckError):
        if case == "mixed_dtypes":
            twins.stream_twin(v, *ops, out_dtype=torch.bfloat16)
        elif case == "wsum_bf16":
            twins.wsum_twin(v, ops[0].to(torch.bfloat16),
                            ops[1].to(torch.bfloat16), *ops[2:])
        else:
            twins.nv7_sweep(v, *ops)
