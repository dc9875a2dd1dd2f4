"""The camera CSRs' ``order`` and the fixed summation order it gives the
camera-major kernels (``normal_blocks``' camera side, ``cam_reduce``).

On the card those kernels walk camera c's sorted slots
``order[offsets[c]:offsets[c+1]]`` in chunks of ``CHUNK`` slots, sum each
chunk in slot order and add a camera's chunk sums in chunk order.  Here a
Python sum that follows that order (camera by camera, chunk by chunk, slot
by slot, U and g_c rebuilt per observation) is held against the port's
plain versions and the JAX package's references on the same numpy inputs.

Tolerances: the sums differ from the references only in their order, so
against the port's plain versions (same float32 terms) rtol 1e-4 and atol
1e-5 x max|ref|; against the JAX package the rule of
tests/test_pallas_kernels.py (rtol 5e-3, atol 1e-5 x max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.ops import pallas_kernels as pk
from ccm_slam_tpu.solvers import ba as jba
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.ops import ba_kernels as bk
from ccm_slam_tpu_torch.solvers import reproj

DELTA = 2.447651936


def close(ours, ref, rtol, atol_scale=1e-5):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol_scale * np.abs(ref).max() + 1e-6)


def slot_sums(rows, csr, C):
    """out[c] = sum of rows[order[j]] over camera c's slots j: each chunk of
    CHUNK slots in slot order, then the chunk sums in chunk order."""
    out = torch.zeros((C,) + tuple(rows.shape[1:]), dtype=rows.dtype)
    for c in range(C):
        beg, end = int(csr.offsets[c]), int(csr.offsets[c + 1])
        for b in range(int(csr.chunks[c + 1] - csr.chunks[c])):
            part = torch.zeros_like(out[c])
            for j in range(beg + b * bk.CHUNK, min(beg + (b + 1) * bk.CHUNK, end)):
                part += rows[int(csr.order[j])]
            out[c] += part
    return out


def ids_with_drops(rng, E, C):
    """Camera ids in [0, C) with some -1, -2 and >= C mixed in."""
    ci = rng.randint(0, C, E).astype(np.int32)
    bad = rng.rand(E) < 0.1
    ci[bad] = rng.choice([-2, -1, C, C + 3], int(bad.sum()))
    return ci


@pytest.mark.parametrize("build", ["cam_csr", "reduce_csr"])
@pytest.mark.parametrize("E,C", [(600, 9), (4096, 40), (1001, 1), (9000, 3)])
def test_order_sorts_slots_stably(build, E, C):
    """``order`` is a permutation that sorts the ids stably (each camera's
    slots hold its observations in ascending order)."""
    ci = torch.as_tensor(ids_with_drops(np.random.RandomState(E + C), E, C))
    csr = bk.cam_csr(ci.reshape(-1, 1), C) if build == "cam_csr" else bk.reduce_csr(ci, C)
    order = csr.order.long()
    assert csr.order.dtype == torch.int32 and csr.order.shape == (E,)
    assert torch.equal(torch.sort(order).values, torch.arange(E))
    if build == "cam_csr":
        key = csr.ci.reshape(-1).long()
    else:
        key = torch.where((ci >= 0) & (ci < C), ci, C).long()
    assert torch.all(key[order][1:] >= key[order][:-1])
    # slots of one camera hold its observations in ascending order (stable)
    for c in range(C):
        seg = order[int(csr.offsets[c]):int(csr.offsets[c + 1])]
        assert torch.all(key[seg] == c) and torch.all(seg[1:] > seg[:-1])
    # each camera's chunks cover its slots in pieces of CHUNK; the kernels'
    # grid of E // CHUNK + C blocks holds them all
    lens = (csr.offsets[1:] - csr.offsets[:-1]).long()
    assert torch.equal((csr.chunks[1:] - csr.chunks[:-1]).long(), -(-lens // bk.CHUNK))
    assert int(csr.chunks[0]) == 0 and int(csr.chunks[C]) <= E // bk.CHUNK + C


def test_drop_bucket_holds_exactly_the_dropped_rows():
    rng = np.random.RandomState(3)
    E, C = 2000, 17
    ci = ids_with_drops(rng, E, C)
    csr = bk.reduce_csr(torch.as_tensor(ci), C)
    kept = int(csr.offsets[C])
    dropped = np.nonzero((ci < 0) | (ci >= C))[0]
    assert kept == E - dropped.size and dropped.size > 0
    np.testing.assert_array_equal(csr.order[kept:].numpy(), dropped)  # in row order
    for c in range(C):
        seg = csr.order[int(csr.offsets[c]):int(csr.offsets[c + 1])].numpy()
        np.testing.assert_array_equal(seg, np.nonzero(ci == c)[0])


@pytest.mark.parametrize("E,C,F", [(3000, 64, 6), (1500, 130, 42), (777, 50, 13),
                                   (4000, 3, 6)])
def test_cam_reduce_in_slot_order_matches_references(E, C, F):
    rng = np.random.RandomState(E + F)
    y = rng.randn(E, F).astype(np.float32)
    ci = ids_with_drops(rng, E, C)
    yt, cit = torch.as_tensor(y), torch.as_tensor(ci)
    csr = bk.reduce_csr(cit, C)
    ours = slot_sums(yt, csr, C)
    close(ours, bk.cam_reduce_plain(yt, cit, C), 1e-4)
    ref = jax.jit(pk.cam_reduce_reference, static_argnums=2)(jnp.asarray(y), jnp.asarray(ci), C)
    close(ours, ref, 1e-4)


def normal_blocks_in_slot_order(prob, C):
    """U, V, g_c, g_p and the cost summed in the card's order: V, g_p and
    the cost over each landmark's K slots in slot order; U and g_c rebuilt
    per observation and summed over each camera's CSR slots in slot order."""
    csr = bk.cam_csr(prob.cam_idx, C)
    ci = csr.ci.long()
    Rc = prob.R[ci]
    r, Xc, w, chi2, _ = reproj.obs_residuals(Rc, prob.t[ci], prob.X, prob.point_valid, prob.uv,
                                             prob.sigma2, prob.obs_valid, prob.intr, DELTA)
    Jc, Jp = reproj.pose_point_jacobians(Rc, Xc, prob.intr[0], prob.intr[1])
    gate = (w > 0)[..., None, None].float()
    Jc = Jc * gate * (~prob.cam_fixed)[ci][..., None, None].float()
    Jp = Jp * gate
    wJc, wJp = Jc * w[..., None, None], Jp * w[..., None, None]
    P, K = prob.cam_idx.shape
    U_e = torch.einsum("pkij,pkil->pkjl", wJc, Jc).reshape(P * K, 6, 6)
    g_e = -torch.einsum("pkij,pki->pkj", wJc, r).reshape(P * K, 6)
    V = torch.zeros(P, 3, 3)
    g_p = torch.zeros(P, 3)
    V_e = torch.einsum("pkij,pkil->pkjl", wJp, Jp)
    gp_e = -torch.einsum("pkij,pki->pkj", wJp, r)
    rho = reproj.huber_rho(chi2, DELTA)
    cost = torch.zeros(())
    for k in range(K):
        V += V_e[:, k]
        g_p += gp_e[:, k]
        cost += rho[:, k].sum()
    U = slot_sums(U_e, csr, C)
    g_c = slot_sums(g_e, csr, C)
    return U, V, g_c, g_p, cost


@pytest.mark.parametrize("K", [4, 12, 16])
def test_normal_blocks_in_slot_order_match_references(K):
    """Fixed cameras, invalid points and observations, and out-of-range
    camera ids (clamped, as BA clamps them): invalid slots carry id -1, as
    local BA's padding does, so camera 0's segment spans several chunks;
    the last three cameras are fixed."""
    C = 11
    arr = problems.small_ba_problem_arrays(P=300, K=K, C=C, seed=K, fixed=3)
    arr["cam_fixed"] = arr["cam_fixed"][::-1].copy()
    arr["cam_idx"][~arr["obs_valid"]] = -1
    arr["cam_idx"][:3, 0] = [-1, C, C + 4]
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    csr = bk.cam_csr(prob.cam_idx, C)
    assert K < 12 or int(csr.chunks[1]) > 1
    U, V, g_c, g_p, cost = normal_blocks_in_slot_order(prob, C)
    assert torch.all(U[-3:] == 0) and torch.all(g_c[-3:] == 0)
    assert float(U[0].abs().max()) > 0

    plain = bk.normal_blocks_plain(prob.R, prob.t, prob.X, prob.point_valid, prob.cam_idx,
                                   prob.uv, prob.sigma2, prob.obs_valid, prob.cam_fixed,
                                   prob.intr, DELTA)
    for ours, ref in zip((U, V, g_c, g_p), (plain[0], plain[1], plain[3], plain[4])):
        close(ours, ref, 1e-4)
    assert abs(float(cost) - float(plain[5])) <= 1e-5 * abs(float(plain[5])) + 1e-4

    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})
    build = jax.jit(lambda p: jba._build_normal_blocks(p, p.R, p.t, p.X, DELTA, trans=None))
    Uj, Vj, _, g_cj, g_pj, _ = build(jp)
    for ours, ref in zip((U, V, g_c, g_p), (Uj, Vj, g_cj, g_pj)):
        close(ours, ref, 5e-3)
    cost_j = float(jax.jit(lambda p: jba._cost(p, p.R, p.t, p.X, DELTA))(jp))
    assert abs(float(cost) - cost_j) < 1e-4 * abs(cost_j) + 1e-2


@pytest.mark.parametrize("K", [1, 8, 12, 16, 32, 256, 300, 1024])
def test_point_layout_keeps_landmarks_whole(K):
    threads, L = bk.point_layout(K)
    assert threads & (threads - 1) == 0 and threads >= 256
    assert L >= 1 and L * K <= threads  # no landmark straddles two blocks


def test_point_layout_rejects_what_one_block_cannot_hold():
    for K in (0, 1025):
        with pytest.raises(ValueError):
            bk.point_layout(K)
