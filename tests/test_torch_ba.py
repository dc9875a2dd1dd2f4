"""The port's bundle adjustment against the JAX package on the CPU, and the
port's package-level contracts (device choice, import isolation, state
transfer).

Solver parity is held to the bounds of the JAX package's own parity check
between its distributed and single-device GBA (__graft_entry__.py:144-148):
final cost within 0.05*cost + 1e-3, camera centres within 5e-3."""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ccm_slam_tpu.solvers import ba as jba
from ccm_slam_tpu_torch import convert, device, problems
from ccm_slam_tpu_torch.solvers import ba as tba

REPO = Path(__file__).resolve().parents[1]

PROBLEMS = {
    # dense Schur branch (C <= 96): local-BA-sized, Huber active, masks
    "dense": lambda: problems.small_ba_problem_arrays(P=700, K=4, C=40),
    # PCG branch (C > 96): a strongly constrained arc so centres compare
    "pcg": lambda: problems.arc_problem_arrays(C=100, P=1024, K=4),
}


def jax_problem(arr):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})


def centres(R, t):
    return -np.einsum("cji,cj->ci", np.asarray(R), np.asarray(t))


def assert_same_optimum(ours, ref):
    cost, cost_ref = float(ours[3]), float(ref[3])
    assert abs(cost - cost_ref) <= 0.05 * cost_ref + 1e-3, (cost, cost_ref)
    err = np.linalg.norm(centres(ours[0], ours[1]) - centres(ref[0], ref[1]), axis=-1).max()
    assert err < 5e-3, err


@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_ba_solve_matches_jax(branch):
    arr = PROBLEMS[branch]()
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    assert (prob.R.shape[0] > tba.PCG_MIN_C) == (branch == "pcg")
    ours = tba.ba_solve(prob, iters=20)
    ref = jba.ba_solve(jax_problem(arr), iters=20)
    assert_same_optimum(ours, ref)
    cost0 = float(tba._cost(prob, prob.R, prob.t, prob.X, 2.447651936))
    assert float(ours[3]) < 0.5 * cost0  # the 2 px noise floor of "dense" is ~0.2x
    assert abs(int(ours[4]) - int(ref[4])) <= 0.01 * int(ref[4])
    # fixed cameras receive no update (only the SO(3) re-projection of R)
    fixed = prob.cam_fixed
    torch.testing.assert_close(ours[0][fixed], prob.R[fixed], rtol=0, atol=1e-6)
    torch.testing.assert_close(ours[1][fixed], prob.t[fixed], rtol=0, atol=1e-6)


def branches_taken(monkeypatch, module, solve):
    """Names of the Schur solvers ``solve`` calls inside ``module``."""
    taken = []
    for name in ("_solve_schur", "_solve_schur_pcg"):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    solve()
    return set(taken)


@pytest.mark.parametrize("C,env,branch", [(96, None, "dense"), (97, None, "pcg"),
                                          (97, "100", "dense"), (96, "50", "pcg")])
def test_branch_threshold_reads_ccm_pcg_min_c_like_jax(monkeypatch, C, env, branch):
    """Both packages take the PCG branch for C > CCM_PCG_MIN_C (96 when the
    variable is unset), reading the variable when the solve starts (the
    JAX solve when it is traced)."""
    if env is None:
        monkeypatch.delenv("CCM_PCG_MIN_C", raising=False)
    else:
        monkeypatch.setenv("CCM_PCG_MIN_C", env)
    arr = problems.small_ba_problem_arrays(P=64, K=4, C=C)
    want = {"dense": {"_solve_schur"}, "pcg": {"_solve_schur_pcg"}}[branch]
    assert branches_taken(monkeypatch, tba, lambda: tba.ba_solve(
        convert.ba_problem_from_numpy(arr, "cpu"), iters=1, with_stats=False)) == want
    raw = functools.partial(jba.ba_solve.__wrapped__, iters=1, with_stats=False)
    assert branches_taken(monkeypatch, jba, lambda: jax.eval_shape(raw, jax_problem(arr))) == want


@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_chunked_equals_monolithic(branch):
    prob = convert.ba_problem_from_numpy(PROBLEMS[branch](), "cpu")
    R, t, X, cost, n_good = tba.ba_solve(prob, iters=12)
    chunk, state = prob, None
    for i in range(3):
        out = tba.ba_solve(chunk, iters=4, state=state, return_state=True,
                           with_stats=(i == 2))
        chunk, state = chunk.replace(R=out[0], t=out[1], X=out[2]), out[5]
    assert float(out[3]) == float(cost)
    assert int(out[4]) == int(n_good)
    for a, b in zip(out[:3], (R, t, X)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lm_state_moves_between_packages():
    """4 iterations in JAX, then 4 in the port from JAX's state, against 8
    in JAX: the interruptible contract holds across the two packages."""
    arr = PROBLEMS["dense"]()
    jp = jax_problem(arr)
    R, t, X, _, _, state = jba.ba_solve(jp, iters=4, return_state=True)
    fields = convert.ba_problem_fields(jp.replace(R=R, t=t, X=X))
    prob = convert.ba_problem_from_numpy(fields, "cpu")
    ours = tba.ba_solve(prob, iters=4, state=convert.lm_state_from_numpy(state, "cpu"),
                        return_state=True)
    ref = jba.ba_solve(jp, iters=8, return_state=True)
    assert_same_optimum(ours, ref)
    lam, dc, cost = convert.lm_state_to_numpy(ours[5])
    assert dc.shape == (40, 6) and np.isfinite(lam) and float(cost) == float(ours[3])


def test_classify_outliers_matches_jax():
    arr = PROBLEMS["dense"]()
    jp = jax_problem(arr)
    R, t, X, _, _ = jba.ba_solve(jp, iters=10)
    ref = np.asarray(jba.classify_outliers(jp, R, t, X))
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    ours = tba.classify_outliers(prob, *(torch.tensor(np.asarray(a)) for a in (R, t, X)))
    assert (ours.numpy() != ref).mean() < 1e-3  # only chi2 ties at the gate may differ
    assert ours.sum() > 0


def test_inverses_match_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 6, 6)).astype(np.float32)
    spd = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
    np.testing.assert_allclose(tba.inv3x3(torch.tensor(spd[:, :3, :3])).numpy(),
                               np.asarray(jba.inv3x3(jnp.asarray(spd[:, :3, :3]))),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tba.inv6x6_spd(torch.tensor(spd)).numpy(),
                               np.asarray(jba.inv6x6_spd(jnp.asarray(spd))),
                               rtol=1e-4, atol=1e-6)


def test_problem_builders_match_reference_side():
    ours = problems.ba_problem_arrays(C=16, P=64, K=4, seed=3)
    ref = convert.ba_problem_fields(bench.make_problem(C=16, P=64, K=4, seed=3))
    from test_pallas_kernels import _small_ba_problem

    ours_small = problems.small_ba_problem_arrays(P=70, K=3, C=9, seed=4, fixed=3)
    ref_small = convert.ba_problem_fields(_small_ba_problem(P=70, K=3, C=9, seed=4, fixed=3))
    for a, b in ((ours, ref), (ours_small, ref_small)):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(np.asarray(a[name]), b[name], err_msg=name)


def test_ba_problem_from_numpy_dtypes():
    prob = convert.ba_problem_from_numpy(problems.small_ba_problem_arrays(P=20, K=3, C=4),
                                         "cpu")
    assert prob.cam_idx.dtype == torch.int32 and prob.obs_valid.dtype == torch.bool
    assert prob.R.dtype == torch.float32 and prob.fx.shape == ()
    with pytest.raises(KeyError):
        convert.ba_problem_from_numpy({"R": np.eye(3)}, "cpu")


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device.resolve_device()
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda")
    with pytest.raises(RuntimeError):  # entry points default to the card
        problems.make_problem(C=4, P=8, K=2)
    assert device.resolve_device("cpu") == torch.device("cpu")


FORBIDDEN = ("jax", "flax", "ccm_slam_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax():
    """Every module of the port (walked with pkgutil, so new modules are
    covered without a list) imports without JAX, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ccm_slam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ccm_slam_tpu_torch.__path__,\n"
        "                                               'ccm_slam_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 40, names\n"
        "bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.')\n"
        f"                                   for f in {FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def _imported_modules(path: Path) -> set:
    """Top-level module names a file imports (absolute imports, any depth)."""
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py and the repo's tools it imports name no JAX, flax or
    JAX-package module in any import statement."""
    files = [REPO / "chip_smoke.py"]
    files += [REPO / (n.replace(".", "/") + ".py") for n in sorted(_imported_modules(files[0]))
              if n.startswith("tools.") and (REPO / (n.replace(".", "/") + ".py")).exists()]
    for path in files:
        bad = sorted(n for n in _imported_modules(path) if _forbidden(n))
        assert not bad, (path.name, bad)
    assert {p.name for p in files} >= {"chip_smoke.py", "kernel_timing.py", "mma_b1_rate.py"}
