"""CPU tests of the benchmark harness (run from the repository root):

    python -m pytest portbench -q -p no:randomly

They hold the manifest to the benchmark's contract, find every file it
names, keep JAX and the JAX package out of everything the harness runs,
hold the plain references to the port at small sizes, check the frozen
byte and operation counts by hand, drive whole runs of small cells on the
CPU (a metric and a cell added as data only; faults planted in the timed
path turn ``correct`` false), and, on a card, the control.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import counts, harness
from portbench.gen import corridor, gba_maps
from portbench.reference import ba_ref, orb_ref

ROOT = os.path.dirname(harness.BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "ccm_slam_tpu", "benchmarks"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(ROOT)


def test_manifest_names_units_and_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] == 1 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert "setup_s" in names
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one each
        assert sum(cell in ws for ws in e2e.values()) >= 2
        assert any(cell in m["workloads"] for m in manifest["per_layer"])
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_listed_file_is_found_by_name(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in manifest["workloads"]:
        _, config, traffic, _, per_layer = harness.cell_spec(manifest, ROOT, w["name"])
        assert os.path.isfile(os.path.join(harness.BENCH, "cells", f"{traffic['kind']}.py"))
    for m in manifest["per_layer"]:
        r = harness.load_reader(ROOT, m["name"])
        assert (r.NAME, r.UNIT, r.LAYER, r.MOVES, r.SOURCE) == (
            m["name"], m["unit"], m["layer"], m["moves"], m["source"])
        assert r.PASS in ("spans", "profile")
        if hasattr(r, "SPAN"):
            import importlib

            assert callable(getattr(importlib.import_module(r.SPAN[0]), r.SPAN[1]))


def _top_imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                assert not _top_imports(os.path.join(dirpath, f)) & FORBIDDEN, f
    code = ("import sys, json, importlib; sys.path.insert(0, sys.argv[1]);"
            "import portbench.harness, portbench.cells.gba, portbench.cells.client,"
            " portbench.calibrate;"
            "[portbench.harness.load_reader(sys.argv[1], m['name']) for m in"
            " portbench.harness.load_manifest(sys.argv[1])['per_layer']];"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "ccm_slam_tpu_torch" in loaded and not loaded & FORBIDDEN


def _map_problem(m):
    from portbench.cells.gba import _problem

    return _problem(m)


SMALL_MAP = dict(generator="corridors", base_seed=1, agents=1, kf_per_agent=40,
                 landmarks_per_kf=12, obs_hist=[0, 0, 3, 3, 2, 1], window_kf=4, shared_kf=0,
                 octave_hist=[4, 3, 2, 1], slots=8)


@pytest.mark.parametrize("sizes", [SMALL_MAP, dict(SMALL_MAP, agents=3, kf_per_agent=36,
                                                   shared_kf=10)])
def test_reference_ba_agrees_with_the_port_on_the_cpu(sizes):
    from ccm_slam_tpu_torch.solvers import ba

    m = gba_maps.make_map(dict(map=sizes), 2**31 + 3, torch.device("cpu"))
    R, t, X, cost, _ = ba.ba_solve(_map_problem(m), iters=20, cg_iters=16)
    m64 = ba_ref.as_dtype(m, torch.float64)
    ref = ba_ref.solve(m64, 20, 16)
    pb = ba_ref.Problem(m64)
    c = float(pb.cost(R.double(), t.double(), X.double()))
    c0 = float(pb.cost(m64["R"], m64["t"], m64["X"]))
    assert abs(c - float(ref["cost"])) / float(ref["cost"]) < 1e-3
    assert abs(float(cost) - c) / c < 1e-5
    assert float(ref["cost"]) < 0.5 * c0  # the solve does the work


def test_reference_orb_agrees_with_the_port_on_the_cpu():
    from ccm_slam_tpu_torch import config
    from ccm_slam_tpu_torch.ops import orb

    cfg = config.rendered_ci_config(0.4)
    cam = {k: getattr(cfg.camera, k) for k in ("width", "height", "fx", "fy", "cx", "cy",
                                                 "k1", "k2", "p1", "p2", "fps")}
    frames = corridor.Corridor(3, 20, (0.0, 0.022), cam, torch.device("cpu")).frames(2**31 + 9)
    ex = cfg.extractor
    for i in (0, 7):
        img = frames[i]
        prog = orb.extract(img.to(torch.float32), n_features=ex.n_features,
                           n_levels=ex.n_levels, scale_factor=ex.scale_factor,
                           ini_th=float(ex.ini_th_fast), min_th=float(ex.min_th_fast),
                           cell=ex.cell_size, capacity=cfg.capacity.max_keypoints)
        ref = orb_ref.extract(img, ex.n_features, ex.n_levels, ex.scale_factor, ex.ini_th_fast,
                              ex.min_th_fast, ex.cell_size, cfg.capacity.max_keypoints)
        bad, total = orb_ref.mismatched_slots(vars(prog), ref)
        assert total > 0.9 * ex.n_features and bad == 0


def test_frozen_counts_equal_hand_counts():
    C, P, K = 3, 5, 2  # E = 10
    problem = 4 * 9 * 3 + 4 * 3 * 3 + 4 * 3 * 5 + 5 + 4 * 10 + 8 * 10 + 4 * 10 + 10
    assert counts.call_counts("reproj_cost", C, P, K) == (problem + 16 + 4, 400)
    nb_out = 4 * (18 * 10) + 4 * 9 * 5 + 4 * 3 * 5 + 4 * 36 * 3 + 4 * 6 * 3 + 4
    assert counts.call_counts("normal_blocks", C, P, K) == (problem + 3 + 16 + nb_out, 4000)
    assert counts.call_counts("schur_off", C, P, K) == (72 + 720 + 180 + 40 + 72, 800)
    assert counts.call_counts("schur_rhs", C, P, K) == (60 + 720 + 40 + 72, 360)
    assert counts.call_counts("schur_wtv", C, P, K) == (72 + 720 + 40 + 60, 360)
    assert counts.call_counts("cam_broadcast", C, P, K) == (144 + 40 + 480, 0)
    b = counts.launches_bound_s({"schur_off": 2, "hamming_top2": 5}, C, P, K)
    assert b == pytest.approx(2 * 1084 / 3.35e12)


# -- whole runs of small cells on the CPU ------------------------------------

TINY_GBA = dict(kind="gba", trace_steps=1,
                map=dict(SMALL_MAP, base_seed=0, agents=2, kf_per_agent=50, shared_kf=10,
                         slots=32))


def _tiny_root(tmp_path, manifest, cells):
    """A copy of the benchmark's data under tmp_path with small cells added
    as files and manifest entries only."""
    root = tmp_path / "root"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads(json.dumps(manifest))
    for name, (config, traffic, config_file) in cells.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        if config_file is not None:
            (root / "portbench" / "configs" / f"{config}.json").write_text(json.dumps(config_file))
            man["configs"].append(dict(name=config, source="test", file=f"portbench/configs/"
                                       f"{config}.json", reduced=[], why="test"))
        man["workloads"].append(dict(name=name, config=config, traffic=name, chips=1, why="t"))
    for m in man["end_to_end"] + man["per_layer"]:
        src = [w for w in m.get("workloads", []) if w in ("gba.fused4", "client.corridor")]
        for name, (config, traffic, _) in cells.items():
            kind = "gba.fused4" if traffic["kind"] == "gba" else "client.corridor"
            if kind in src:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return str(root), man


def _gba_limits(manifest):
    return harness.cell_spec(manifest, ROOT, "gba.fused4")[2]["checks"]


def test_a_metric_and_a_cell_are_added_as_data_only(tmp_path, manifest):
    root, man = _tiny_root(tmp_path, manifest, {
        "tiny.gba": ("server_gba", dict(TINY_GBA, checks=_gba_limits(manifest)), None)})
    (tmp_path / "root" / "portbench" / "metrics" / "fixture.solves_traced.py").write_text(
        'NAME = "fixture.solves_traced"\nUNIT = "solves"\nLAYER = "LM driver"\n'
        'MOVES = "gba_solve_ms"\nSOURCE = "program_counter"\nPASS = "profile"\n\n\n'
        'def read(ctx):\n    return float(ctx["counters"]["solves"])\n')
    man["per_layer"].append(dict(name="fixture.solves_traced", unit="solves", better="higher",
                                 source="program_counter", layer="LM driver",
                                 moves="gba_solve_ms", workloads=["tiny.gba"]))
    out, _ = harness.run_cell(root, "tiny.gba", 5, 0.5, False, torch.device("cpu"), manifest=man)
    assert out["correct"] and out["attempted"] >= 1 and "gba_solve_ms" in out["metrics"]
    out, _ = harness.run_cell(root, "tiny.gba", 5, 0.5, True, torch.device("cpu"), manifest=man)
    assert out["correct"] and out["metrics"]["fixture.solves_traced"]["value"] == 1.0
    assert list(out)[-1] == "checks"


def _unchanged(solve):
    def broken(prob, *a, **kw):
        out = solve(prob, *a, **kw)
        return (prob.R, prob.t, prob.X, out[3] * 0 + 1.0, *out[4:])
    return broken


def _half_batch(solve):
    def broken(prob, *a, **kw):
        P = prob.obs_valid.shape[0]
        keep = (torch.arange(P) < P // 2)[:, None]
        out = solve(prob.replace(obs_valid=prob.obs_valid & keep), *a, **kw)
        return (*out[:3], out[3] * 2.0, *out[4:])
    return broken


def _altered(solve):
    def broken(prob, *a, **kw):
        out = solve(prob, *a, **kw)
        t = out[1].clone()
        t[-1] += 0.5
        return (out[0], t, *out[2:])
    return broken


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch, _altered])
def test_gba_faults_in_the_timed_path_turn_correct_false(tmp_path, manifest, monkeypatch, fault):
    from ccm_slam_tpu_torch.solvers import ba

    root, man = _tiny_root(tmp_path, manifest, {
        "tiny.gba": ("server_gba", dict(TINY_GBA, checks=_gba_limits(manifest)), None)})
    if fault is not None:
        monkeypatch.setattr(ba, "ba_solve", fault(ba.ba_solve))
    out, rows = harness.run_cell(root, "tiny.gba", 6, 0.5, False, torch.device("cpu"),
                                 manifest=man)
    assert out["correct"] == (fault is None), rows


def _tiny_client(manifest):
    from ccm_slam_tpu_torch import config

    cfg = config.rendered_ci_config(0.4)  # the EuRoC camera at 0.4 and its feature budget
    c = json.loads(open(os.path.join(ROOT, "portbench", "configs", "euroc_client.json")).read())
    c.update(name="tiny_client", camera={k: getattr(cfg.camera, k) for k in c["camera"]},
             capacity=dict(client_max_kfs=64, client_max_mps=8192, max_obs_per_mp=16))
    ex = cfg.extractor
    c["extractor"] = dict(n_features=ex.n_features, n_levels=ex.n_levels,
                          scale_factor=ex.scale_factor, ini_th_fast=ex.ini_th_fast,
                          min_th_fast=ex.min_th_fast, cell_size=ex.cell_size,
                          max_keypoints=cfg.capacity.max_keypoints)
    t = dict(harness.cell_spec(manifest, ROOT, "client.corridor")[2])
    t.update(frames=40, span=[0.0, 0.044], warm_frames=12, warm_local_bas=1, trace_steps=1)
    return c, t


def _flip_bit(extract):
    def broken(*a, **kw):
        f = extract(*a, **kw)
        d = f.desc.clone()
        d[0, 0] ^= 1
        return type(f)(xy=f.xy, response=f.response, octave=f.octave, angle=f.angle, desc=d,
                       valid=f.valid)
    return broken


def _half_features(extract):
    def broken(*a, **kw):
        f = extract(*a, **kw)
        keep = torch.arange(f.valid.shape[0], device=f.valid.device) % 2 == 0
        return type(f)(xy=f.xy, response=f.response, octave=f.octave, angle=f.angle,
                       desc=f.desc, valid=f.valid & keep)
    return broken


def _after_setup(fn, make_broken, on):
    """``fn`` until ``on[0]`` is set, then ``make_broken(fn)``."""
    broken = make_broken(fn)

    def switch(*a, **kw):
        return (broken if on[0] else fn)(*a, **kw)
    return switch


def _client_faults():
    from portbench.cells import client

    return [None, *client.FAULTS, "half_features", "flipped_bit"]


@pytest.mark.parametrize("fault", _client_faults())
def test_client_faults_in_the_timed_path_turn_correct_false(tmp_path, manifest, monkeypatch,
                                                           fault):
    from ccm_slam_tpu_torch.ops import orb
    from portbench import calibrate
    from portbench.cells import client

    torch.set_num_threads(4)
    config, traffic = _tiny_client(manifest)
    root, man = _tiny_root(tmp_path, manifest, {"tiny.client": ("tiny_client", traffic, config)})
    on = [False]
    if fault in ("half_features", "flipped_bit"):
        make = _half_features if fault == "half_features" else _flip_bit
        monkeypatch.setattr(orb, "extract", _after_setup(orb.extract, make, on))
    real = client.Cell.__init__

    def init(self, *a, **kw):  # the timed path breaks once set-up is over
        real(self, *a, **kw)
        on[0] = True

    monkeypatch.setattr(client.Cell, "__init__", init)
    kind = fault if fault in client.FAULTS else "program"
    out, rows, _ = calibrate.run(root, man, "tiny.client", 8, 3.0, torch.device("cpu"), kind)
    assert out["correct"] == (fault is None), rows


def _pose_problem():
    g = torch.Generator().manual_seed(2**31 + 5)
    N = 400
    X = torch.rand(N, 3, generator=g) * torch.tensor([8.0, 6.0, 8.0]) + torch.tensor(
        [-4.0, -3.0, 4.0])
    uv = torch.stack([458.0 * X[:, 0] / X[:, 2] + 367.0, 457.0 * X[:, 1] / X[:, 2] + 248.0], -1)
    uv = uv + torch.randn(N, 2, generator=g)
    uv[:40] += 30.0  # outliers
    sigma2 = 1.44 ** torch.randint(0, 4, (N,), generator=g).float()
    valid = torch.rand(N, generator=g) < 0.9
    R0, t0 = torch.eye(3), torch.tensor([0.05, -0.03, 0.08])
    return R0, t0, X, uv, valid, sigma2, (458.0, 457.0, 367.0, 248.0)


def test_reference_pose_agrees_with_the_port_on_the_cpu():
    from ccm_slam_tpu_torch.solvers import pose_opt
    from portbench.reference import pose_ref

    R0, t0, X, uv, valid, sigma2, intr = _pose_problem()
    R, t, _, _ = pose_opt.optimize_pose(R0, t0, X, uv, valid, sigma2, *intr)
    Rr, tr, active, c_ref = pose_ref.solve(R0, t0, X, uv, valid, sigma2, intr)
    c = pose_ref.cost_at(R, t, X, uv, sigma2, active, intr)
    assert abs(c - c_ref) / c_ref < 1e-4
    assert float(torch.linalg.norm(tr)) < 0.02 and int(active.sum()) < int(valid.sum())
    c0 = pose_ref.cost_at(R0, t0, X, uv, sigma2, active, intr)
    assert (c0 - c_ref) / c_ref > 1.0  # the start is far from the optimum


def test_the_pose_check_follows_both_sides_of_the_chi2_gate(monkeypatch):
    """A pose that a tie at the gate sent down another path reads as that
    path's optimum, and as a gap on the nominal path alone."""
    from portbench.cells import client
    from portbench.reference import pose_ref

    R0, t0, X, uv, valid, sigma2, intr = _pose_problem()
    inputs = ((R0, t0, X, uv, valid, sigma2, *intr), {})
    monkeypatch.setattr(pose_ref, "TIE", 1.0)  # a band wide enough to hold ties
    paths = pose_ref.solve_all(R0, t0, X, uv, valid, sigma2, intr)
    assert 1 < len(paths) <= pose_ref.MAX_PATHS
    assert torch.equal(paths[0][2], pose_ref.solve(R0, t0, X, uv, valid, sigma2, intr)[2])
    nominal = paths[0][2]
    R, t, _, _ = next(p for p in paths[1:] if abs(
        pose_ref.cost_at(p[0], p[1], X, uv, sigma2, nominal, intr) - paths[0][3])
        / paths[0][3] > 1e-3)
    assert client.Cell._pose_gap(inputs, R, t) < 1e-12
    monkeypatch.setattr(pose_ref, "TIE", 0.0)
    assert client.Cell._pose_gap(inputs, R, t) > 1e-3


# -- on the card ---------------------------------------------------------------


def _cells():
    return [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_the_control_is_not_correct_on_the_card(manifest, cell):
    """Each cell at its own size, a short window: the program is correct,
    the control in its place is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run there")
    from portbench import calibrate

    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    sound, rows, _ = calibrate.run(ROOT, manifest, cell, 2**31 + 17, 3.0, dev)
    ctrl, ctrl_rows, _ = calibrate.run(ROOT, manifest, cell, 2**31 + 17, 3.0, dev, "control")
    assert sound["correct"], rows
    assert not ctrl["correct"], ctrl_rows


def test_seed_streams_take_any_whole_number():
    a = gba_maps.make_map(dict(map=SMALL_MAP), 2**31 + 11, torch.device("cpu"))
    b = gba_maps.make_map(dict(map=SMALL_MAP), 2**31 + 11, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert isinstance(corridor._rng(2**40 + 1, 3).randn(), float)
    assert np.isfinite(corridor._rng(2**31 + 1, 1, 5).randn())


@pytest.mark.parametrize("raw, short", [
    ("reproj_cost_kernel(float const*, float const*, int)", "reproj_cost_kernel"),
    ("void normal_blocks_point_kernel<8>(float const*, int)", "normal_blocks_point_kernel"),
    ("(anonymous namespace)::schur_point_kernel(float const*, int)", "anon::schur_point_kernel"),
    ("void at::native::(anonymous namespace)::roll_cuda_kernel<float>(float const*, long)",
     "anon::roll_cuda_kernel"),
    ("std::enable_if<true, void>::type internal::gemvx::kernel<int, float>(cublasGemvParamsEx)",
     "gemvx::kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH")])
def test_device_operation_names_reduce_to_their_function(raw, short):
    from portbench import trace

    assert trace._short(raw) == short


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ccm_slam_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
                          "gba.agent1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0 and res.stdout == "" and "CUDA" in res.stderr


def test_the_roofline_reader_finds_the_ba_kernels_in_a_trace():
    r = harness.load_reader(ROOT, "ba_kernels_roofline")
    C, P, K = 4, 10, 2
    bound = counts.launches_bound_s({"schur_off": 3}, C, P, K)
    ctx = dict(counters=dict(launches={"schur_off": 3}, shape=(C, P, K)),
               profile=dict(time_by_kernel={"anon::schur_point_kernel": 4 * bound,
                                            "native::elementwise_kernel": 1.0}))
    assert r.read(ctx) == pytest.approx(25.0)
    ctx["profile"]["time_by_kernel"] = {"native::elementwise_kernel": 1.0}
    assert r.read(ctx) is None
