"""The port's Sim(3) solvers and pose graph against the JAX package's, on
seeded numpy inputs handed to both packages.

RANSAC: the JAX side draws its hypotheses from a key
(``jax.random.categorical``, as its ``ransac_sim3`` does); the port gets those
indices.  Tolerances: alignments and refined Sim3s within 1e-4 (float32 SVD
and sums in another order), inlier masks equal; edge Jacobians within 1e-4
of max|J| (forward-mode AD against ``jax.jacobian``); pose-graph vertices
within 1e-4 (dense LU) or 2e-3 (48 truncated CG steps) and costs within
1e-4 relative + 1e-6 (segment sums in another order), on a graph whose edge
errors are not exactly zero.  Where an edge's
error rotation is exactly symmetric, both packages' Jacobians are NaN and the
graph returns its initial vertices (a reference defect the port mirrors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.solvers import pose_graph as jpg
from ccm_slam_tpu.solvers import sim3 as jsim3
from ccm_slam_tpu.utils.lie import Sim3 as JSim3
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.solvers import pose_graph as pg
from ccm_slam_tpu_torch.solvers import sim3
from ccm_slam_tpu_torch.utils.lie import Sim3

INTR = (458.654, 457.296, 367.215, 248.375)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Batched 3x3 products are per-op overhead on the CPU: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jsim(f):
    return JSim3(s=jnp.asarray(f["s"]), R=jnp.asarray(f["R"]), t=jnp.asarray(f["t"]))


def tsim(f):
    return convert.sim3_from_numpy(f, "cpu")


def sim_fields(rng, n=None, scale=0.3):
    """A batch (or one) of random Sim3s from the JAX exponential map."""
    shape = (7,) if n is None else (n, 7)
    return convert.sim3_fields(JSim3.exp(jnp.asarray(rng.normal(0, scale, shape), jnp.float32)))


def assert_sim_close(ours: Sim3, ref, atol=1e-4):
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=atol, err_msg=name)


def correspondences(seed=0, N=120, outliers=0.25):
    """Landmarks in camera 2, the same in camera 1 through a Sim3, their
    pixels with 0.5 px noise, a quarter replaced by outliers."""
    rng = np.random.default_rng(seed)
    Xc2 = (rng.uniform(-2, 2, (N, 3)) + [0, 0, 7]).astype(np.float32)
    S = JSim3(s=jnp.float32(1.15), R=JSim3.exp(jnp.asarray([0, 0, 0, 0.05, -0.1, 0.03, 0],
                                                            jnp.float32)).R,
              t=jnp.asarray([0.3, -0.1, 0.2], jnp.float32))
    Xc1 = np.asarray(S.apply(jnp.asarray(Xc2)))
    fx, fy, cx, cy = INTR

    def pix(X):
        return np.stack([fx * X[:, 0] / X[:, 2] + cx, fy * X[:, 1] / X[:, 2] + cy], -1)

    uv1 = (pix(Xc1) + rng.normal(0, 0.5, (N, 2))).astype(np.float32)
    uv2 = (pix(Xc2) + rng.normal(0, 0.5, (N, 2))).astype(np.float32)
    bad = rng.random(N) < outliers
    uv1[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(np.float32)
    valid = rng.random(N) > 0.1
    octave = rng.integers(0, 4, N)
    sigma2 = (1.44 ** octave).astype(np.float32)
    return dict(Xc1=Xc1, Xc2=Xc2, uv1=uv1, uv2=uv2, valid=valid, s2_1=sigma2,
                s2_2=sigma2[::-1].copy())


@pytest.mark.parametrize("mode", ["uniform", "weighted", "fix_scale"])
def test_umeyama_alignment_matches_jax(mode):
    rng = np.random.default_rng(3)
    P2 = rng.normal(0, 2, (64, 3)).astype(np.float32)
    S = jsim(sim_fields(rng))
    P1 = np.asarray(S.apply(jnp.asarray(P2))) + rng.normal(0, 0.01, (64, 3)).astype(np.float32)
    w = (rng.random(64) > 0.3).astype(np.float32) if mode == "weighted" else None
    fix = mode == "fix_scale"
    ref = jsim3.umeyama_alignment(jnp.asarray(P1), jnp.asarray(P2),
                                  None if w is None else jnp.asarray(w), fix_scale=fix)
    ours = sim3.umeyama_alignment(torch.as_tensor(P1), torch.as_tensor(P2),
                                  None if w is None else torch.as_tensor(w), fix_scale=fix)
    assert_sim_close(ours, ref)
    if fix:
        assert float(ours.s) == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_sim3_matches_jax_on_its_samples(seed):
    d = correspondences(seed)
    key = jax.random.PRNGKey(seed + 10)
    valid = jnp.asarray(d["valid"])
    idx = jax.random.categorical(key, jnp.log(valid.astype(jnp.float32) + 1e-12), shape=(300, 3))
    gate1, gate2 = 9.210 * d["s2_1"], 9.210 * d["s2_2"]
    S_r, inl_r, n_r = jsim3.ransac_sim3(key, *(jnp.asarray(d[k]) for k in
                                               ("Xc1", "Xc2", "uv1", "uv2", "valid")),
                                        jnp.asarray(gate1), jnp.asarray(gate2), *INTR)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    S, inl, n = sim3.ransac_sim3(t["Xc1"], t["Xc2"], t["uv1"], t["uv2"], t["valid"],
                                 torch.as_tensor(gate1), torch.as_tensor(gate2), *INTR,
                                 idx=torch.as_tensor(np.asarray(idx)))
    assert int(n) == int(n_r) and int(n) > 50
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_r))
    assert_sim_close(S, S_r)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    d = correspondences(2)
    init = convert.sim3_fields(JSim3(s=jnp.float32(1.1), R=JSim3.exp(jnp.asarray(
        [0, 0, 0, 0.04, -0.12, 0.02, 0], jnp.float32)).R, t=jnp.asarray([0.25, -0.05, 0.3])))
    keys = ("Xc1", "Xc2", "uv1", "uv2", "valid", "s2_1", "s2_2")
    S_r, inl_r, n_r = jsim3.optimize_sim3(jsim(init), *(jnp.asarray(d[k]) for k in keys), *INTR,
                                          fix_scale=fix_scale)
    S, inl, n = sim3.optimize_sim3(tsim(init), *(torch.as_tensor(d[k]) for k in keys), *INTR,
                                   fix_scale=fix_scale)
    assert int(n) == int(n_r) and int(n) > 40
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_r))
    assert_sim_close(S, S_r)


def pose_graph_fields():
    return problems.pose_graph_arrays()


def jax_problem(f):
    return jpg.PoseGraphProblem(S_w=jsim(f["S_w"]), S_meas=jsim(f["S_meas"]),
                                **{k: jnp.asarray(f[k]) for k in
                                   ("fixed", "vert_valid", "i_idx", "j_idx", "edge_valid",
                                    "weight")})


def test_edge_jacobians_match_jax():
    jp = jax_problem(pose_graph_fields())
    prob = convert.pose_graph_problem_from_numpy(convert.pose_graph_problem_fields(jp), "cpu")
    z = jnp.zeros(7)

    def blocks(e):
        S_iw = jax.tree.map(lambda x: x[jp.i_idx[e]], jp.S_w)
        S_jw = jax.tree.map(lambda x: x[jp.j_idx[e]], jp.S_w)
        S_ij = jax.tree.map(lambda x: x[e], jp.S_meas)
        return (jpg._edge_error(z, z, S_iw, S_jw, S_ij),
                jax.jacobian(lambda x: jpg._edge_error(x, z, S_iw, S_jw, S_ij))(z),
                jax.jacobian(lambda x: jpg._edge_error(z, x, S_iw, S_jw, S_ij))(z))

    ref = jax.jit(jax.vmap(blocks))(jnp.arange(jp.i_idx.shape[0]))
    ours = pg._edge_system(prob, prob.S_w, prob.i_idx.long(), prob.j_idx.long())
    for name, a, b in zip(("err", "Ji", "Jj"), ours, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_matches_jax(solver):
    f = pose_graph_fields()
    prob = convert.pose_graph_problem_from_numpy(f, "cpu")
    S_r, cost_r = jax.jit(jpg.optimize_pose_graph, static_argnames=("iters", "solver"))(
        jax_problem(f), iters=10, solver=solver)
    S, cost = pg.optimize_pose_graph(prob, iters=10, solver=solver)
    cost0 = float(pg._cost(prob, prob.S_w, prob.i_idx.long(), prob.j_idx.long()))
    assert float(cost) < 0.5 * cost0
    assert abs(float(cost) - float(cost_r)) <= 1e-4 * float(cost_r) + 1e-6
    # 48 truncated CG steps amplify the rounding of sums taken in another order
    assert_sim_close(S, S_r, atol=1e-4 if solver == "dense" else 2e-3)
    # frozen vertices (fixed, invalid) keep their poses bit for bit
    frozen = prob.fixed | ~prob.vert_valid
    assert torch.equal(S.t[frozen], prob.S_w.t[frozen])


def test_pose_graph_empty_slot_edge_is_nan_like_jax():
    """The essential graph's spanning-tree edge of an empty keyframe slot (an
    identity pose, its parent clipped to slot 0) has the error rotation
    R0^T R0, exactly symmetric: both packages' Jacobians are NaN there,
    NaN * 0 reaches the normal equations of the free slot 0 through the
    invalid edge, and no step is accepted (the reference's behaviour,
    mirrored)."""
    f = pose_graph_fields()
    k = int(np.where(~f["vert_valid"])[0][0])
    f["S_w"]["s"][k], f["S_w"]["R"][k], f["S_w"]["t"][k] = 1.0, np.eye(3), 0.0
    f["i_idx"][0], f["j_idx"][0], f["edge_valid"][0] = k, 0, False
    f["fixed"] = np.arange(len(f["fixed"])) == 2  # slot 0 free, as in a loop's graph
    S_w = jsim(f["S_w"])
    rel = jpg.relative_sim3(jax.tree.map(lambda x: x[k], S_w), jax.tree.map(lambda x: x[0], S_w))
    for name in ("s", "R", "t"):
        f["S_meas"][name][0] = np.asarray(getattr(rel, name))
    prob = convert.pose_graph_problem_from_numpy(f, "cpu")
    _, Ji, _ = pg._edge_system(prob, prob.S_w, prob.i_idx.long(), prob.j_idx.long())
    assert torch.isnan(Ji[0]).any() and torch.isfinite(Ji[1:]).all()
    S_r, cost_r = jax.jit(jpg.optimize_pose_graph, static_argnames=("iters",))(
        jax_problem(f), iters=3)
    S, cost = pg.optimize_pose_graph(prob, iters=3)
    np.testing.assert_array_equal(np.asarray(S_r.t), f["S_w"]["t"])
    assert torch.equal(S.t, prob.S_w.t) and torch.equal(S.R, prob.S_w.R)
    assert abs(float(cost) - float(cost_r)) <= 1e-4 * float(cost_r)


def test_segment_sums_are_fixed_order_and_exact_layout():
    rng = np.random.default_rng(5)
    keys = torch.as_tensor(rng.integers(0, 9, 500))
    rows = torch.as_tensor(rng.normal(size=(500, 7, 7)).astype(np.float32))
    seg = pg.Segments(keys, 11)
    out = seg.sum(rows)
    ref = torch.zeros(11, 7, 7, dtype=torch.float64).index_add_(0, keys, rows.double())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, seg.sum(rows))  # same bits on a rerun
    assert seg.width == int(torch.bincount(keys).max())
    assert torch.equal(out[9:], torch.zeros(2, 7, 7))  # keys with no rows stay 0
