"""The fixed summation orders of the card's ``schur_ops`` (off, rhs, wtv;
``make_schur_matvec`` runs off's kernels) and ``reproj_cost``.

On the card, off runs one thread per observation in blocks of whole
landmarks: y1_e = W_e^T v[ci_e], y1_p summed over the landmark's K slots in
slot order, y2_p = Vinv_p y1_p, y3_e = W_e y2_p written in observation order;
then each camera's CSR slots (``CamCSR.order``) are summed chunk by chunk
(``cam_reduce``'s chunk kernel: 42 row strides, then a fixed tree) and the
chunk sums per camera by one block (256 thread strides, a shuffle tree per
warp, the warps in order).  rhs writes y3_e = W_e q_p and sums it per
camera as off does; wtv returns off's y1_p.
``reproj_cost`` takes one Huber term per observation in the same blocks,
tree-sums each block and sums the block partials in one fixed pass.  Here a
numpy float32 sum in exactly those orders, on the same inputs, is held
against the port's plain versions and the JAX package's references (jitted
goldens and the Pallas kernels in interpret mode).

Tolerances: the sums differ only in their order (and, on the card, in FMA
contraction), so against the port's plain versions rtol 1e-4 and atol 1e-5 x
max|ref|; against the JAX package the rules of tests/test_torch_ba_kernels.py
(off: rtol 1e-4, atol 1e-3; cost: 1e-4 relative + 1e-2).
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
F32 = np.float32


def tree(vals, first):
    """The kernels' fixed tree over rows of ``vals`` [n, ...]: for h = first,
    first/2, ..., 1, row r < h gains row r + h where that row exists."""
    vals = vals.copy()
    h = first
    while h > 0:
        n = min(h, max(vals.shape[0] - h, 0))
        vals[:n] = vals[:n] + vals[h:h + n]
        h //= 2
    return vals[0]


def strided_sums(rows, stride):
    """[stride, ...] partials: partial r sums rows r, r + stride, ... in order."""
    acc = np.zeros((stride,) + rows.shape[1:], F32)
    for m in range(0, rows.shape[0], stride):
        blk = rows[m:m + stride]
        acc[:blk.shape[0]] = acc[:blk.shape[0]] + blk
    return acc


def block_columns(rows):
    """Column sums of rows [n, 6] as a 256-thread block takes them: thread t
    adds rows t, t + 256, ... in order; a shuffle tree per warp; the eight
    warp sums in order."""
    acc = strided_sums(rows, 256)
    total = np.zeros(rows.shape[1:], F32)
    for w in range(8):
        total = total + tree(acc[32 * w:32 * w + 32], 16)
    return total


def camera_sums(y3, csr, C):
    """Camera sums of y3 [E,6] in the card's order: each CHUNK-slot chunk of
    a camera's CSR segment as ``cam_reduce_kernel`` sums it (F=6: 42 row
    strides, then the tree from 32), then one block per camera over its
    chunk sums (``schur_off_combine_kernel``)."""
    order, offsets = csr.order.numpy(), csr.offsets.numpy()
    out = np.zeros((C, 6), F32)
    for c in range(C):
        chunks = [tree(strided_sums(y3[order[lo:min(lo + bk.CHUNK, offsets[c + 1])]], 42), 32)
                  for lo in range(offsets[c], offsets[c + 1], bk.CHUNK)]
        if chunks:
            out[c] = block_columns(np.stack(chunks))
    return out


def y1_in_kernel_order(W, ci, v):
    """y1_p = sum_k W_pk^T v[ci_pk] as the point kernel sums it (off's y1_p,
    wtv's result); ci [P,K] already clipped."""
    P, K = ci.shape
    y1_e = np.zeros((P, K, 3), F32)
    for i in range(6):  # y1_e[j] = sum_i W[i][j] v[ci][i], i in order
        y1_e = y1_e + W[:, :, i, :] * v[ci][:, :, i:i + 1]
    y1 = np.zeros((P, 3), F32)
    for k in range(K):  # the landmark's slots in order
        y1 = y1 + y1_e[:, k]
    return y1


def rows_in_kernel_order(W, y):
    """y3_e = W_e y_p(e) [P*K,6] per observation, as the point kernel forms it."""
    y3 = (W[:, :, :, 0] * y[:, None, None, 0] + W[:, :, :, 1] * y[:, None, None, 1]
          + W[:, :, :, 2] * y[:, None, None, 2])
    return y3.reshape(-1, 6).astype(F32)


def off_in_kernel_order(W, Vinv, ci, v, C):
    """off(v) summed as the card sums it; ci [P,K] already clipped."""
    y1 = y1_in_kernel_order(W, ci, v)
    y2 = Vinv[:, :, 0] * y1[:, :1] + Vinv[:, :, 1] * y1[:, 1:2] + Vinv[:, :, 2] * y1[:, 2:]
    csr = bk.cam_csr(torch.as_tensor(ci), C)
    return camera_sums(rows_in_kernel_order(W, y2), csr, C)


def skewed_schur_inputs(P, K, C, seed):
    """Random W, Vinv, v; a fifth of the slots valid, the rest on camera 0
    (the initialization BA's padding) with zero W rows; two ids out of
    range (clipped)."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(P, K) < 0.2
    ci = np.where(valid, rng.randint(0, C, (P, K)), 0).astype(np.int32)
    ci[0, :2] = [-1, C + 3]
    W = (rng.randn(P, K, 6, 3) * valid[..., None, None]).astype(F32)
    Vinv = rng.randn(P, 3, 3).astype(F32)
    v = rng.randn(C, 6).astype(F32)
    return W, Vinv, ci, v


def close(ours, ref, rtol, atol_scale):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol_scale * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("P,K,C", [(300, 4, 33), (300, 12, 9), (1400, 16, 20)])
def test_schur_off_in_kernel_order_matches_references(P, K, C):
    """K = 4, 12 and 16; camera 0 owns ~80% of the slots (at P=1400, K=16,
    over 32 chunks, so more than one warp of its combining block has work)."""
    W, Vinv, ci, v = skewed_schur_inputs(P, K, C, seed=P + K)
    cic = np.clip(ci, 0, C - 1)
    csr = bk.cam_csr(torch.as_tensor(ci), C)
    assert int(csr.chunks[1]) >= (33 if K == 16 else 2)
    ours = off_in_kernel_order(W, Vinv, cic, v, C)
    Wt, Vt, vt = torch.as_tensor(W), torch.as_tensor(Vinv), torch.as_tensor(v)
    close(ours, bk.schur_ops_plain(Wt, Vt, torch.as_tensor(ci), C)[0](vt), 1e-4, 1e-5)
    close(ours, bk.schur_ops(Wt, Vt, csr)[0](vt), 1e-4, 1e-5)
    close(ours, bk.make_schur_matvec(Wt, Vt, torch.as_tensor(ci), C)(vt), 1e-4, 1e-5)
    Wj, Vj, cj = jnp.asarray(W), jnp.asarray(Vinv), jnp.asarray(ci)
    ref = jax.jit(lambda x: pk.schur_matvec_reference(Wj, Vj, cj, C)(x))(jnp.asarray(v))
    close(ours, ref, 1e-4, 1e-5)
    WT = jnp.asarray(np.pad(W.reshape(P * K, 18).T, ((0, 6), (0, 0))))
    off_k = pk.make_schur_ops(Vj, cj, C, WT=WT, exact=True, interpret=True)[0]
    np.testing.assert_allclose(ours, np.asarray(off_k(jnp.asarray(v))), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("P,K,C", [(300, 4, 33), (300, 12, 9), (1400, 16, 20)])
def test_schur_rhs_and_wtv_in_kernel_order_match_references(P, K, C):
    """rhs: W_e q_p per observation, summed per camera through the CSR
    chunks as off's y3; wtv: off's y1_p.  Camera 0 owns ~80% of the slots,
    whose W rows are zero; two ids out of range (clipped)."""
    W, Vinv, ci, v = skewed_schur_inputs(P, K, C, seed=P + K + 1)
    q = np.random.RandomState(P + K + 2).randn(P, 3).astype(F32)
    csr = bk.cam_csr(torch.as_tensor(ci), C)
    rhs = camera_sums(rows_in_kernel_order(W, q), csr, C)
    wtv = y1_in_kernel_order(W, np.clip(ci, 0, C - 1), v)
    Wt, Vt, qt, vt = (torch.as_tensor(a) for a in (W, Vinv, q, v))
    for ops in (bk.schur_ops_plain(Wt, Vt, torch.as_tensor(ci), C), bk.schur_ops(Wt, Vt, csr)):
        close(rhs, ops[1](qt), 1e-4, 1e-5)
        close(wtv, ops[2](vt), 1e-4, 1e-5)
    Wj, Vj, cj = jnp.asarray(W), jnp.asarray(Vinv), jnp.asarray(ci)
    close(rhs, jax.jit(lambda x: pk.schur_rhs_reference(Wj, cj, C)(x))(jnp.asarray(q)), 1e-4,
          1e-5)
    close(wtv, jax.jit(lambda x: pk.schur_wtv_reference(Wj, cj, C)(x))(jnp.asarray(v)), 1e-4,
          1e-5)
    WT = jnp.asarray(np.pad(W.reshape(P * K, 18).T, ((0, 6), (0, 0))))
    _, rhs_k, wtv_k = pk.make_schur_ops(Vj, cj, C, WT=WT, exact=True, interpret=True)
    np.testing.assert_allclose(rhs, np.asarray(rhs_k(jnp.asarray(q))), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(wtv, np.asarray(wtv_k(jnp.asarray(v))), rtol=1e-4, atol=1e-3)


def cost_in_kernel_order(prob):
    """reproj_cost summed as the card sums it: one Huber term per
    observation, blocks of point_layout(K) whole landmarks tree-summed
    (threads past the block's observations add 0), then the partials in
    one 256-thread pass (strided sums, then the tree)."""
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    ci = prob.cam_idx.clamp(0, C - 1).long()
    _, _, _, chi2, _ = reproj.obs_residuals(prob.R[ci], prob.t[ci], prob.X, prob.point_valid,
                                            prob.uv, prob.sigma2, prob.obs_valid, prob.intr,
                                            DELTA)
    rho = reproj.huber_rho(chi2, DELTA).numpy().astype(F32).reshape(-1)
    threads, L = bk.point_layout(K)
    nb = -(-P // L)
    blocks = np.zeros((nb, threads), F32)
    flat = np.zeros(nb * L * K, F32)
    flat[:rho.size] = rho
    blocks[:, :L * K] = flat.reshape(nb, L * K)
    partials = np.array([tree(b, threads // 2) for b in blocks], F32)
    return tree(strided_sums(partials, 256), 128)


def cost_problem(name):
    if name == "ragged K=12":
        arr = problems.small_ba_problem_arrays(P=3001, K=12, C=37, seed=12, fixed=5)
        arr["cam_idx"][~arr["obs_valid"]] = -1  # local BA's padding, clamped to camera 0
        arr["cam_idx"][:4, 0] = [-1, 37, 40, -3]
        return arr
    if name == "init BA":
        return problems.init_ba_problem_arrays(C=160, P=2048, K=16, n_points=300)
    return problems.small_ba_problem_arrays(P=700, K=4, C=40, seed=4)


@pytest.mark.parametrize("name", ["ragged K=12", "init BA", "K=4"])
def test_reproj_cost_in_kernel_order_matches_references(name):
    arr = cost_problem(name)
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    C = prob.R.shape[0]
    ours = cost_in_kernel_order(prob)
    args = (prob.R, prob.t, prob.X, prob.point_valid, prob.cam_idx, prob.uv, prob.sigma2,
            prob.obs_valid, prob.intr)
    plain = float(bk.reproj_cost_plain(*args, DELTA))
    assert abs(float(ours) - plain) <= 1e-4 * abs(plain) + 1e-4
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})
    cost_j = float(jax.jit(lambda p: jba._cost(p, p.R, p.t, p.X, DELTA))(jp))
    assert abs(float(ours) - cost_j) <= 1e-4 * abs(cost_j) + 1e-2
    if name == "K=4":  # the Pallas kernel in interpret mode (K <= 16)
        ref = pk.fused_reproj_cost(jp.R, jp.t, jp.X, jp.point_valid, jp.cam_idx, jp.uv,
                                   jp.sigma2, jp.obs_valid, C, jp.fx, jp.fy, jp.cx, jp.cy,
                                   DELTA, interpret=True)
        assert abs(float(ours) - float(ref)) <= 1e-4 * abs(float(ref)) + 1e-2


def test_reproj_cost_keeps_nan():
    """A NaN landmark (a non-finite trial state) gives a non-finite cost in
    both packages and in the kernel's order, so LM's finite test rejects
    the step."""
    arr = problems.small_ba_problem_arrays(P=700, K=4, C=40, seed=4)
    arr["X"][17, 1] = np.nan
    prob = convert.ba_problem_from_numpy(arr, "cpu")
    assert not np.isfinite(cost_in_kernel_order(prob))
    assert not torch.isfinite(bk.reproj_cost(prob.R, prob.t, prob.X, prob.point_valid,
                                             prob.cam_idx, prob.uv, prob.sigma2,
                                             prob.obs_valid, prob.intr, DELTA))
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})
    assert not np.isfinite(float(jax.jit(lambda p: jba._cost(p, p.R, p.t, p.X, DELTA))(jp)))
    ref = pk.fused_reproj_cost(jp.R, jp.t, jp.X, jp.point_valid, jp.cam_idx, jp.uv, jp.sigma2,
                               jp.obs_valid, 40, jp.fx, jp.fy, jp.cx, jp.cy, DELTA,
                               interpret=True)
    assert not np.isfinite(float(ref))
