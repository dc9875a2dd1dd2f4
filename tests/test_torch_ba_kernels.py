"""The port's BA kernel functions on the CPU (their plain versions) against
the JAX package's goldens and its Pallas kernels in interpret mode, at the
shapes and tolerances of tests/test_pallas_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.ops import pallas_kernels as pk
from ccm_slam_tpu.solvers import ba as jba
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.ops import ba_kernels as bk

DELTA = 2.447651936


def jax_problem(arr):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})


def port_args(prob):
    return (prob.R, prob.t, prob.X, prob.point_valid, prob.cam_idx, prob.uv,
            prob.sigma2, prob.obs_valid)


def close_blocks(ours, ref, rel=5e-3):
    """test_pallas_kernels' rule: f32 summation-order noise scales with the
    accumulation magnitude, so atol is tied to the largest block entry."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=1e-5 * np.abs(ref).max() + 1e-6)


def close_cost(ours, ref):
    assert abs(float(ours) - float(ref)) < 1e-4 * abs(float(ref)) + 1e-2


def _blocks(P, K, C, fixed=2):
    arr = problems.small_ba_problem_arrays(P=P, K=K, C=C, seed=P, fixed=fixed)
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    csr = bk.cam_csr(prob.cam_idx, C)
    out = bk.normal_blocks(*port_args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    return arr, prob, out


@pytest.mark.parametrize("P,K,C", [(700, 4, 40), (300, 8, 130), (257, 12, 9)])
def test_normal_blocks_match_jax(P, K, C):
    arr, _, (U, V, W, g_c, g_p, cost) = _blocks(P, K, C)
    jp = jax_problem(arr)
    Uj, Vj, Wj, g_cj, g_pj, _ = jba._build_normal_blocks(jp, jp.R, jp.t, jp.X, DELTA,
                                                         trans=None)
    close_blocks(U, Uj)
    close_blocks(V, Vj)
    close_blocks(W, Wj)
    close_blocks(g_c, g_cj)
    close_blocks(g_p, g_pj)
    close_cost(cost, jba._cost(jp, jp.R, jp.t, jp.X, DELTA))


def test_normal_blocks_fixed_cameras_zeroed():
    _, _, (U, V, _, g_c, _, _) = _blocks(300, 4, 20, fixed=5)
    assert torch.all(U[:5] == 0) and torch.all(g_c[:5] == 0)
    assert float(V.abs().sum()) > 0  # fixed cameras still constrain landmarks


def test_normal_blocks_match_pallas_interpret():
    P, K, C = 257, 12, 9
    arr, _, (U, V, W, g_c, g_p, cost) = _blocks(P, K, C)
    jp = jax_problem(arr)
    Uk, Vk, WTk, g_ck, g_pk, costk = pk.fused_normal_blocks(
        jp.R, jp.t, jp.X, jp.point_valid, jp.cam_idx, jp.uv, jp.sigma2, jp.obs_valid,
        jp.cam_fixed, C, jp.fx, jp.fy, jp.cx, jp.cy, DELTA, interpret=True,
    )
    for ours, ref in ((U, Uk), (V, Vk), (W, pk.unpack_WT(WTk, P, K)), (g_c, g_ck),
                      (g_p, g_pk)):
        close_blocks(ours, ref)
    close_cost(cost, costk)


@pytest.mark.parametrize("P,K,C,interpret", [(500, 8, 33, False), (257, 4, 9, True)])
def test_reproj_cost_matches_jax(P, K, C, interpret):
    arr = problems.small_ba_problem_arrays(P=P, K=K, C=C, seed=3)
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    ours = bk.reproj_cost(*port_args(prob), prob.intr, DELTA)
    jp = jax_problem(arr)
    if interpret:
        ref = pk.fused_reproj_cost(jp.R, jp.t, jp.X, jp.point_valid, jp.cam_idx, jp.uv,
                                   jp.sigma2, jp.obs_valid, C, jp.fx, jp.fy, jp.cx, jp.cy,
                                   DELTA, interpret=True)
    else:
        ref = jba._cost(jp, jp.R, jp.t, jp.X, DELTA)
    close_cost(ours, ref)


def _schur_inputs(P, K, C):
    rng = np.random.RandomState(P)
    W = rng.randn(P, K, 6, 3).astype(np.float32)
    Vinv = rng.randn(P, 3, 3).astype(np.float32)
    ci = rng.randint(0, C, (P, K)).astype(np.int32)
    v = rng.randn(C, 6).astype(np.float32)
    q = rng.randn(P, 3).astype(np.float32)
    return W, Vinv, ci, v, q


def _port_schur_ops(W, Vinv, ci, C):
    csr = bk.cam_csr(torch.as_tensor(ci), C)
    return bk.schur_ops(torch.as_tensor(W), torch.as_tensor(Vinv), csr)


@pytest.mark.parametrize("P,K,C", [(300, 8, 70), (257, 4, 33)])
def test_schur_ops_match_references(P, K, C):
    W, Vinv, ci, v, q = _schur_inputs(P, K, C)
    off, rhs, wtv = _port_schur_ops(W, Vinv, ci, C)
    Wj, Vj, cj = jnp.asarray(W), jnp.asarray(Vinv), jnp.asarray(ci)
    tol = dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(off(torch.as_tensor(v)).numpy(),
                               np.asarray(pk.schur_matvec_reference(Wj, Vj, cj, C)(v)), **tol)
    np.testing.assert_allclose(rhs(torch.as_tensor(q)).numpy(),
                               np.asarray(pk.schur_rhs_reference(Wj, cj, C)(q)), **tol)
    np.testing.assert_allclose(wtv(torch.as_tensor(v)).numpy(),
                               np.asarray(pk.schur_wtv_reference(Wj, cj, C)(v)), **tol)


def test_schur_ops_match_pallas_interpret():
    P, K, C = 257, 4, 33
    W, Vinv, ci, v, q = _schur_inputs(P, K, C)
    off, rhs, wtv = _port_schur_ops(W, Vinv, ci, C)
    WT = jnp.asarray(np.pad(W.reshape(P * K, 18).T, ((0, 6), (0, 0))))
    off_k, rhs_k, wtv_k = pk.make_schur_ops(jnp.asarray(Vinv), jnp.asarray(ci), C, WT=WT,
                                            exact=True, interpret=True)
    tol = dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(off(torch.as_tensor(v)).numpy(), np.asarray(off_k(v)), **tol)
    np.testing.assert_allclose(rhs(torch.as_tensor(q)).numpy(), np.asarray(rhs_k(q)), **tol)
    np.testing.assert_allclose(wtv(torch.as_tensor(v)).numpy(), np.asarray(wtv_k(v)), **tol)


@pytest.mark.parametrize("E,C,F,oob", [(2048, 64, 6, False), (1000, 130, 13, False),
                                       (777, 50, 4, True)])
def test_cam_broadcast_matches_reference(E, C, F, oob):
    rng = np.random.RandomState(E)
    v = rng.randn(C, F).astype(np.float32)
    ci = rng.randint(-1 if oob else 0, C + 1 if oob else C, E).astype(np.int32)
    ours = bk.cam_broadcast(torch.as_tensor(v), torch.as_tensor(ci))
    ref = pk.cam_broadcast_reference(jnp.asarray(v), jnp.asarray(ci), C)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_cam_broadcast_matches_pallas_interpret():
    rng = np.random.RandomState(5)
    v = rng.randn(130, 13).astype(np.float32)
    ci = rng.randint(-1, 131, 1000).astype(np.int32)
    ours = bk.cam_broadcast(torch.as_tensor(v), torch.as_tensor(ci))
    ref = pk.cam_broadcast(jnp.asarray(v), jnp.asarray(ci), 130, exact=True, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("E,C,F", [(2048, 64, 6), (1000, 130, 42), (777, 50, 13)])
def test_cam_reduce_drops_out_of_range_like_reference(E, C, F):
    """Ids -1 and >= C are dropped (cam_csr would clamp them into camera 0
    and C-1); tolerance 1e-5 relative to the largest entry."""
    rng = np.random.RandomState(E + F)
    y = rng.randn(E, F).astype(np.float32)
    ci = rng.randint(-2, C + 3, E).astype(np.int32)
    ours = bk.cam_reduce(torch.as_tensor(y), torch.as_tensor(ci), C).numpy()
    ref = np.asarray(pk.cam_reduce_reference(jnp.asarray(y), jnp.asarray(ci), C))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    clamped = bk.cam_reduce(torch.as_tensor(y), torch.as_tensor(np.clip(ci, 0, C - 1)), C)
    assert not np.allclose(clamped.numpy(), ref)


def test_cam_reduce_matches_pallas_interpret():
    rng = np.random.RandomState(9)
    y = rng.randn(1500, 42).astype(np.float32)
    ci = rng.randint(-1, 131, 1500).astype(np.int32)
    ours = bk.cam_reduce(torch.as_tensor(y), torch.as_tensor(ci), 130).numpy()
    ref = np.asarray(pk.cam_reduce(jnp.asarray(y), jnp.asarray(ci), 130, exact=True,
                                   interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_reduce_csr_drop_bucket():
    ci = torch.tensor([2, -1, 0, 5, 2, 1, 3], dtype=torch.int32)
    csr = bk.reduce_csr(ci, 3)
    assert csr.offsets.tolist() == [0, 1, 2, 4]  # 4 rows kept, ids -1, 5, 3 dropped
    assert csr.order[:4].tolist() == [2, 5, 0, 4]  # kept rows, by camera, stable
    assert sorted(csr.order[4:].tolist()) == [1, 3, 6]  # the drop bucket


@pytest.mark.parametrize("P,K,C,interpret", [(300, 8, 70, False), (257, 4, 33, True)])
def test_make_schur_matvec_matches_reference(P, K, C, interpret):
    W, Vinv, ci, v, _ = _schur_inputs(P, K, C)
    ci[0, :3] = [-1, C, C + 5]  # out of range: clipped, as the reference clips
    off = bk.make_schur_matvec(torch.as_tensor(W), torch.as_tensor(Vinv), torch.as_tensor(ci), C)
    if interpret:
        ref = pk.make_schur_matvec(jnp.asarray(W), jnp.asarray(Vinv), jnp.asarray(ci), C,
                                   exact=True, interpret=True)(jnp.asarray(v))
    else:
        ref = pk.schur_matvec_reference(jnp.asarray(W), jnp.asarray(Vinv), jnp.asarray(ci),
                                        C)(jnp.asarray(v))
    np.testing.assert_allclose(off(torch.as_tensor(v)).numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-3)


def test_pcg_transitions_match_reference():
    from ccm_slam_tpu_torch.solvers import ba as tba

    rng = np.random.RandomState(4)
    cam_idx = rng.randint(-1, 41, (200, 4)).astype(np.int32)
    broadcast, reduce = tba.pcg_transitions(torch.as_tensor(cam_idx), 40)
    jb, jr = jba._pcg_transitions_pallas(jnp.asarray(cam_idx), 40)
    v = rng.randn(40, 6).astype(np.float32)
    y = rng.randn(800, 6).astype(np.float32)
    np.testing.assert_allclose(broadcast(torch.as_tensor(v)).numpy(),
                               np.asarray(pk.cam_broadcast_reference(
                                   jnp.asarray(v), jnp.clip(jnp.asarray(cam_idx).reshape(-1), 0,
                                                            39), 40)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(reduce(torch.as_tensor(y)).numpy(),
                               np.asarray(pk.cam_reduce_reference(
                                   jnp.asarray(y), jnp.clip(jnp.asarray(cam_idx).reshape(-1), 0,
                                                            39), 40)), rtol=1e-5, atol=1e-5)
    assert callable(jb) and callable(jr)


def test_cam_csr_groups_observations_by_camera():
    rng = np.random.RandomState(0)
    cam_idx = rng.randint(-2, 12, (50, 3)).astype(np.int32)
    csr = bk.cam_csr(torch.as_tensor(cam_idx), 10)
    ci = np.clip(cam_idx, 0, 9).reshape(-1)
    np.testing.assert_array_equal(csr.ci.numpy().reshape(-1), ci)
    order, offsets = csr.order.numpy(), csr.offsets.numpy()
    assert sorted(order.tolist()) == list(range(ci.size))
    for c in range(10):
        owned = np.sort(np.nonzero(ci == c)[0])
        # camera c owns a contiguous run of slots, in observation order (stable)
        np.testing.assert_array_equal(order[offsets[c]:offsets[c + 1]], owned)


def test_wrappers_leave_launch_counts_at_zero_on_cpu():
    bk.reset_launch_counts()
    _, prob, (_, V, W, _, _, _) = _blocks(100, 4, 7)
    bk.reproj_cost(*port_args(prob), prob.intr, DELTA)
    off, rhs, wtv = bk.schur_ops(W, V.contiguous(), bk.cam_csr(prob.cam_idx, 7))
    off(torch.zeros(7, 6)), rhs(torch.zeros(100, 3)), wtv(torch.zeros(7, 6))
    bk.cam_broadcast(torch.zeros(7, 12), prob.cam_idx.reshape(-1).contiguous())
    bk.cam_reduce(torch.zeros(400, 6), prob.cam_idx.reshape(-1).contiguous(), 7)
    bk.make_schur_matvec(W, V.contiguous(), prob.cam_idx, 7)(torch.zeros(7, 6))
    assert all(n == 0 for n in bk.launch_counts().values()), bk.launch_counts()


def test_wrappers_reject_bad_inputs():
    arr = problems.small_ba_problem_arrays(P=50, K=4, C=6)
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    args = list(port_args(prob))
    with pytest.raises(TypeError):  # cam_idx must be int32
        bk.reproj_cost(*args[:4], args[4].long(), *args[5:], prob.intr, DELTA)
    with pytest.raises(ValueError):  # non-contiguous
        bk.reproj_cost(args[0].transpose(1, 2), *args[1:], prob.intr, DELTA)
    with pytest.raises(ValueError):  # wrong shape
        bk.cam_broadcast(torch.zeros(6, 12), torch.zeros(3, 2, dtype=torch.int32))
    csr = bk.cam_csr(prob.cam_idx, 5)
    with pytest.raises(ValueError):  # csr built for another camera count
        bk.normal_blocks(*args, prob.cam_fixed, prob.intr, DELTA, csr)
