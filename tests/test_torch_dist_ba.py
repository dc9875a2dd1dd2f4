"""The port's landmark-sharded GBA (``ccm_slam_tpu_torch/parallel/dist_ba.py``)
at world size 1, in-process over gloo, against the JAX package's
``dist_ba_solve`` on a 1-device mesh: the five cases of
tests/test_dist_ba.py.

Problems are ``problems.arc_problem_arrays`` (numpy, seed 0) at small sizes:
C=8, P=256, K=4 on the dense branch; C=12, P=1024, K=4 on the PCG branch
with ``CCM_PCG_MIN_C=4`` (no other test traces this shape on a 1-device
mesh, and JAX reads the variable when it traces).  The PCG problem has 85
landmarks a camera: with fewer, the truncated CG steps make the LM paths of
JAX's own 1- and 2-device solves part by several 1e-3 in t.  Tolerances:
against JAX, t atol 1e-3 and cost rtol 1e-2 (tests/test_dist_ba.py:28-29);
chunked against monolithic within the port, cost rtol 1e-5 and t atol 1e-6.
Each JAX configuration compiles once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.parallel import dist_ba as jdist
from ccm_slam_tpu.solvers import ba as jba
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.parallel import dist_ba
from ccm_slam_tpu_torch.solvers import ba

HUBER = 2.447651936
SHAPES = {"dense": dict(C=8, P=256, K=4), "pcg": dict(C=12, P=1024, K=4)}
PCG_MIN_C = "4"


def jax_problem(arr):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})


def port_problem(branch):
    return convert.ba_problem_from_numpy(problems.arc_problem_arrays(**SHAPES[branch]), "cpu")


def true_t(C):
    """The arc's exact translations (``problems.arc_problem_arrays``)."""
    return np.stack([[0.02 * i, 0.005 * i, 0.0] for i in range(C)]).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    return dist_ba.make_mesh("cpu")


@pytest.fixture
def branch_env(request, monkeypatch):
    """CCM_PCG_MIN_C lowered for the PCG branch."""
    if request.param == "pcg":
        monkeypatch.setenv("CCM_PCG_MIN_C", PCG_MIN_C)
    return request.param


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's dist_ba_solve on a 1-device mesh, once per branch: 15
    iterations dense, 10 on the PCG branch."""
    jm = jdist.make_mesh(jax.devices()[:1])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for branch, iters in (("dense", 15), ("pcg", 10)):
            if branch == "pcg":
                mp.setenv("CCM_PCG_MIN_C", PCG_MIN_C)
            probs = jdist.shard_problem(jax_problem(problems.arc_problem_arrays(
                **SHAPES[branch])), jm)
            R, t, X, cost = jdist.dist_ba_solve(probs, jm, iters=iters)
            out[branch] = (iters, np.asarray(t), float(cost))
    return out


@pytest.mark.parametrize("branch_env", ["dense", "pcg"], indirect=True)
def test_matches_jax_dist_and_single_device(mesh, jax_runs, branch_env, monkeypatch):
    branch = branch_env
    iters, t_ref, cost_ref = jax_runs[branch]
    prob = port_problem(branch)
    taken = []
    for module, name in ((ba, "_solve_schur_pcg"), (dist_ba, "_dense_step")):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    R, t, X, cost = dist_ba.dist_ba_solve(dist_ba.shard_problem(prob, mesh), mesh, iters=iters)
    assert set(taken) == {"_solve_schur_pcg" if branch == "pcg" else "_dense_step"}
    np.testing.assert_allclose(t.numpy(), t_ref, atol=1e-3)
    np.testing.assert_allclose(float(cost), cost_ref, rtol=1e-2)
    # the port's single-device solver lands on the same optimum
    R1, t1, X1, c1, _ = ba.ba_solve(prob, iters=iters)
    np.testing.assert_allclose(t.numpy(), t1.numpy(), atol=1e-3)
    np.testing.assert_allclose(float(cost), float(c1), rtol=1e-2)


def test_converges(mesh):
    prob = port_problem("dense")
    cost0 = float(ba._cost(prob, prob.R, prob.t, prob.X, HUBER))
    R, t, X, cost = dist_ba.dist_ba_solve(dist_ba.shard_problem(prob, mesh), mesh, iters=20)
    assert float(cost) < 0.05 * cost0
    err_t = float(np.linalg.norm(t.numpy() - true_t(prob.R.shape[0]), axis=-1).max())
    assert err_t < 2e-2, err_t
    # the gauge cameras do not move
    assert torch.equal(t[:2], prob.t[:2]) and torch.equal(R[:2], prob.R[:2])


@pytest.mark.parametrize("branch_env", ["dense", "pcg"], indirect=True)
def test_chunked_equals_monolithic_with_state_carry(mesh, branch_env):
    """Three 4-iteration chunks carrying (lam, warm start, cost) follow the
    monolithic 12-iteration solve."""
    probs = dist_ba.shard_problem(port_problem(branch_env), mesh)
    R1, t1, X1, c1 = dist_ba.dist_ba_solve(probs, mesh, iters=12)
    state, pc = None, probs
    for _ in range(3):
        R2, t2, X2, c2, state = dist_ba.dist_ba_solve(pc, mesh, iters=4, state=state,
                                                      return_state=True)
        pc = pc.replace(R=R2, t=t2, X=X2)
    np.testing.assert_allclose(float(c2), float(c1), rtol=1e-5)
    np.testing.assert_allclose(t2.numpy(), t1.numpy(), atol=1e-6)
    assert float(state[2]) == float(c2)


def test_sharding_layout(mesh):
    """Each rank keeps its contiguous block of landmark rows, as JAX's
    sharding over a 2-device mesh places them; camera arrays stay whole; the
    world size must divide P."""
    arr = problems.arc_problem_arrays(**SHAPES["dense"])
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    jm = jdist.make_mesh(jax.devices()[:2])
    probs = jdist.shard_problem(jax_problem(arr), jm)
    assert len(probs.X.sharding.device_set) == 2
    for rank, dev in enumerate(jax.devices()[:2]):
        shard = dist_ba.shard_problem(prob, dataclasses.replace(mesh, rank=rank, world_size=2))
        for f in dist_ba.LANDMARK_FIELDS:
            ref = [s.data for s in getattr(probs, f).addressable_shards if s.device == dev][0]
            np.testing.assert_array_equal(getattr(shard, f).numpy(), np.asarray(ref))
        for f in ("R", "t", "cam_fixed", "fx"):
            assert torch.equal(getattr(shard, f), getattr(prob, f))
    # world size 1: the whole problem, and gather_points gives X back
    whole = dist_ba.shard_problem(prob, mesh)
    assert mesh.world_size == 1 and torch.equal(whole.X, prob.X)
    assert torch.equal(dist_ba.gather_points(whole.X, mesh), prob.X)
    odd = convert.ba_problem_from_numpy(problems.arc_problem_arrays(C=8, P=257, K=4), "cpu")
    with pytest.raises(ValueError, match="do not divide"):
        dist_ba.shard_problem(odd, dataclasses.replace(mesh, world_size=2))


def test_backend_pairing_is_checked(mesh):
    """gloo serves the CPU only; a second make_mesh reuses the group; the
    card needs NCCL and, without a card, make_mesh on it raises."""
    assert mesh.backend == "gloo" and dist_ba.make_mesh("cpu").group is mesh.group
    on_card = dataclasses.replace(mesh, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="gloo"):
        dist_ba._check_device(torch.device("cuda", 0), on_card)
    with pytest.raises(ValueError, match="the mesh on"):
        dist_ba.shard_problem(port_problem("dense"), on_card)
    with pytest.raises(ValueError, match="no collective backend"):
        dist_ba.make_mesh("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist_ba.make_mesh("cuda")
