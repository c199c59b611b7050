"""The harness's data, arithmetic and result line, on the CPU."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfdbench import cell, meshgen, roofline, run, trace
from cfdbench.reference import gg
from cfdbench.tests.conftest import run_small

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
FOREIGN = {"jax", "jaxlib", "flax", "cfd_proxy_tpu"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_its_files_by_name(workload):
    c = cell.find_cell(workload)
    w = {x["name"]: x for x in BENCH["workloads"]}[workload]
    conf = {x["name"]: x for x in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("cfdbench/configs/")
    assert c["config"]["name"] == w["config"]
    assert c["traffic"]["name"] == w["traffic"]
    assert c["traffic"]["ranks"] == w["chips"]
    assert sorted(c["config"]["limits"]) == sorted(cell.CHECKS)
    assert c["config"]["reduced"] == conf["reduced"]
    for name in c["per_layer"]:
        assert callable(cell.metric_reader(name))
    assert c["end_to_end"] == [m["name"] for m in BENCH["end_to_end"]]


def test_benchmark_names_and_units_keep_to_their_characters():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    assert all(name.match(x["name"]) for x in items)
    assert all(unit.match(m["unit"]) for m in BENCH["end_to_end"]
               + BENCH["per_layer"])
    assert {m["moves"] for m in BENCH["per_layer"]} == {"faces_per_s"}


def test_roofline_bytes_of_a_tiny_mesh_by_hand():
    m = meshgen.generate(2, 2, 2, jitter=0.0, diag_frac=0.0, seed=3)
    assert (m.nface, m.npoint) == (12, 8)        # 4 edges along each axis
    # faces 12 × (2 ids + 3 normal) × 4 B; points 8 × (volume + 7 states
    # + 21 gradients) × 4 B
    assert roofline.problem_bytes(m.nface, m.npoint, 7) == 12 * 20 + 8 * 116
    assert roofline.least_seconds(dict(faces=12, points=8, nvar=7, chips=2,
                                       kind=None)) == 1168 / 2 / 3.35e12


def test_the_mesh_is_the_recipes_and_the_state_comes_from_the_seed():
    a = meshgen.generate(5, 4, 3, jitter=0.05, diag_frac=0.2, seed=0)
    b = meshgen.generate(5, 4, 3, jitter=0.05, diag_frac=0.2, seed=0)
    c = meshgen.generate(5, 4, 3, jitter=0.05, diag_frac=0.2, seed=1)
    assert np.array_equal(a.faces, b.faces) and np.array_equal(a.coords,
                                                               b.coords)
    assert not np.array_equal(a.coords, c.coords)
    assert np.all(a.faces[:, 0] < a.faces[:, 1])
    s = meshgen.state(60, 7, 2**31 + 5)
    assert s.dtype == np.float32
    assert np.array_equal(s, meshgen.state(60, 7, 2**31 + 5))
    assert not np.array_equal(s, meshgen.state(60, 7, 5))


def test_the_mesh_is_the_repositorys_recipe():
    # the program's own generator at the same seed: the same mesh
    from cfd_proxy_tpu_torch.mesh.generator import generate_mesh

    a = meshgen.generate(7, 6, 5, jitter=0.05, diag_frac=0.2, seed=0)
    b = generate_mesh(7, 6, 5, jitter=0.05, diag_frac=0.2, seed=0)
    for k in ("coords", "faces", "normals", "volume"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_trace_union_gaps_and_launches_on_a_synthetic_trace():
    # two steps in [0, 100) us: K1 [10, 40), an update overlapping it
    # [35, 50), a copy [60, 70); one kernel starting before the stretch
    device = [(-5, 5, "sweep_packed_kernel"), (10, 40, "sweep_packed_kernel"),
              (35, 50, "chain_update_kernel"),
              (60, 70, "Memcpy DtoD (Device -> Device)"),
              (80, 95, "at::native::index_kernel")]
    host = [(0, 100, "outer"), (45, 75, "cudaDeviceSynchronize")]
    s = trace.summarize(device, host, 0.0, 100.0, steps=2)
    assert s["busy_us"] == 40 + 10 + 15       # [10, 50) ∪ [60, 70) ∪ [80, 95)
    assert s["stretch_us"] == 100
    assert s["gaps"][0] == ["outer", 10.0]    # [0, 10) and [70, 80) tie
    assert ["cudaDeviceSynchronize", 10.0] in s["gaps"]
    assert s["ops"]["sweep_packed_kernel"] == [1, 30.0]
    problem = dict(faces=10, points=4, nvar=1, chips=1, kind=None)
    read = {n: cell.metric_reader(n)([s], problem)
            for n in ("launches_per_step", "glue_ms", "idle_pct",
                      "sweep_roofline_pct", "step_roofline_pct")}
    assert read["launches_per_step"] == 3 / 2          # no copy counted
    assert read["glue_ms"] == pytest.approx((10 + 15) / 2 / 1e3)
    assert read["idle_pct"] == pytest.approx(35.0)
    least = roofline.least_seconds(problem)
    assert read["sweep_roofline_pct"] == pytest.approx(100 * least / 15e-6)
    assert read["step_roofline_pct"] == pytest.approx(100 * least / 50e-6)
    empty = trace.summarize([], host, 0.0, 100.0, steps=2)
    assert cell.metric_reader("sweep_roofline_pct")([empty], problem) is None
    assert cell.metric_reader("idle_pct")([empty], problem) is None
    b = trace.combine([s, s])
    assert b["device_ops"][0][0] == "sweep_packed_kernel"
    assert b["device_ops"][0][1] == pytest.approx(30e-6)
    assert b["idle_gaps"][0][0].startswith("rank ")


def test_interval_p95_sees_a_stall_that_a_median_of_chunks_hides():
    iv = [0.005] * 1000
    base = run.end_to_end([_rank(iv)])
    stalled = list(iv)
    stalled[100:160] = [0.020] * 60         # one stall: 6 % of the window
    hit = run.end_to_end([_rank(stalled)])
    assert base["interval_ms_p95"] == pytest.approx(5.0)
    assert hit["interval_ms_p95"] == pytest.approx(20.0)
    # a median of chunks of 20 (utils/timing's two-point estimator takes
    # the median of such) does not move: 47 of 50 chunks hold no stall
    chunks = np.asarray(stalled).reshape(50, 20).mean(axis=1)
    assert np.median(chunks) == pytest.approx(0.005)
    assert hit["faces_per_s"] < base["faces_per_s"]
    # several ranks: each interval's slowest rank
    two = run.end_to_end([_rank(iv), _rank(stalled)])
    assert two["interval_ms_p95"] == pytest.approx(20.0)


def _rank(intervals):
    return {"intervals_s": intervals, "steps": 32 * len(intervals),
            "window_s": sum(intervals), "faces": 1000, "setup_s": 1.0}


def test_reference_on_two_tetrahedra_by_hand():
    # tet A (0,1,2,3): its six edges with normal (1,0,0); tet B (1,2,3,4):
    # its three new edges with (0,1,0); var[p] = p; volumes 1, 2, 1, 3, 0.5
    faces = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3],
                      [1, 4], [2, 4], [3, 4]], np.int32)
    normals = np.array([[1.0, 0, 0]] * 6 + [[0, 1.0, 0]] * 3)
    volume = np.array([1.0, 2.0, 1.0, 3.0, 0.5])
    m = gg.Mesh64(faces, normals, volume, "cpu")
    var = torch.arange(5, dtype=torch.float64)[:, None]
    g = gg.gradients(m, var)[:, 0, :].numpy()
    # x: 0 gets .5+1+1.5, 1 gets -.5+1.5+2, 2 gets -1-1.5+2.5, 3 gets
    # -1.5-2-2.5; y: 1 gets 2.5, 2 gets 3, 3 gets 3.5, 4 gets -9
    want = np.array([[3, 0, 0], [1.5, 1.25, 0], [0, 3, 0], [-2, 3.5 / 3, 0],
                     [0, -18, 0]])
    assert np.allclose(g, want, rtol=0, atol=1e-15)
    step = gg.chain(m, var, 0.5, 1)[:, 0].numpy()
    assert np.allclose(step, [1.5, 1.75, 2.0, 2.0, 4.0], rtol=0, atol=1e-15)


def test_reference_is_exact_for_a_linear_field_inside_the_grid():
    n = 6
    mesh = meshgen.generate(n, n, n, jitter=0.0, diag_frac=0.0, seed=4)
    lin = mesh.coords @ np.array([0.5, -2.0, 3.0])
    g = gg.gradients(gg.Mesh64(mesh.faces, mesh.normals, mesh.volume, "cpu"),
                     torch.as_tensor(lin)[:, None]).numpy()[:, 0]
    inner = np.all((mesh.coords > 0.5) & (mesh.coords < n - 1.5), axis=1)
    assert inner.sum() == (n - 2) ** 3
    assert np.allclose(g[inner], [0.5, -2.0, 3.0], atol=1e-12)


def test_a_run_line_has_the_contracts_keys_and_checks_last():
    out = run_small("gg96.p1.bulk")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"faces_per_s", "interval_ms_p95",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    assert set(out["checks"]) == set(cell.CHECKS)
    traced = run_small("gg96.p1.bulk", trace=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_the_run_prints_no_result_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "cfdbench.run", "--workload",
                        "gg96.p1.bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    here = os.path.join(ROOT, "cfdbench")
    files = [os.path.join(d, f) for d, _, fs in os.walk(here) for f in fs
             if f.endswith(".py")]
    for f in files:
        assert not set(_imports(f)) & FOREIGN, f
        if os.sep + "reference" + os.sep in f:
            assert "cfd_proxy_tpu_torch" not in set(_imports(f)), f


def test_a_run_loads_no_module_of_jax_or_of_the_jax_package():
    code = ("import sys, time\n"
            "from cfdbench.tests.conftest import run_small\n"
            "from cfdbench import cell\n"
            "out = run_small('gg96.p8.overlap', trace=True)\n"
            "assert out['correct'], out\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(p.stdout.split())
    assert "cfd_proxy_tpu_torch" in loaded
    assert not loaded & FOREIGN
