"""Bundle adjustment with Schur-complement landmark marginalization (PyTorch).

Counterpart of ``ccm_slam_tpu/solvers/ba.py``: the LM solver behind the
server's global BA, the client's local BA, map initialisation and loop
closure.

* Observations live in a fixed-shape per-landmark table ``[P, K]`` (landmark
  p is seen by at most K cameras) with masks -- no sparse graph structure.
* Fixed cameras (the local-BA frontier and the gauge anchors) get zeroed
  pose Jacobians: they still constrain landmarks through V and g_p but
  receive no update.
* Two reduced-camera-system solvers, chosen by shape: the dense Schur
  complement with a Cholesky solve for local-BA sizes (C <= 96, or
  ``CCM_PCG_MIN_C`` when set, as the reference reads it), matrix-free
  block-Jacobi PCG beyond.
* Every LM iteration computes the trial cost and accepts or rejects it with
  ``torch.where``, so LM itself needs no host round-trip; the CG loop stops
  early on its residual, which costs one host sync per CG step.
* ``state`` / ``return_state`` make the solve interruptible: a chunked solve
  follows the same LM path as a monolithic one.

On CUDA tensors the per-observation work runs in the hand-written kernels of
``ops.ba_kernels``; on CPU tensors it runs their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

from ..ops import ba_kernels
from ..utils.lie import orthonormalize, se3_exp
from . import reproj

PCG_MIN_C = 96  # C above this takes the matrix-free PCG branch (unless overridden)


def pcg_min_c() -> int:
    """The branch threshold: ``CCM_PCG_MIN_C`` when set, else PCG_MIN_C."""
    return int(os.environ.get("CCM_PCG_MIN_C", PCG_MIN_C))


@dataclass
class BAProblem:
    """Fixed-shape BA problem instance: C cameras, P landmarks, K observation
    slots per landmark.  All tensors on one device."""

    R: torch.Tensor          # [C,3,3] float32 world->cam rotations
    t: torch.Tensor          # [C,3] float32
    X: torch.Tensor          # [P,3] float32 world points
    cam_idx: torch.Tensor    # [P,K] int32 camera index per obs (any value ok when invalid)
    uv: torch.Tensor         # [P,K,2] float32 undistorted pixel measurements
    sigma2: torch.Tensor     # [P,K] float32 detection variance per obs
    obs_valid: torch.Tensor  # [P,K] bool
    cam_fixed: torch.Tensor  # [C] bool: frontier cameras (and gauge anchor)
    point_valid: torch.Tensor  # [P] bool
    fx: torch.Tensor         # 0-d float32 intrinsics
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    def replace(self, **changes) -> "BAProblem":
        return dataclasses.replace(self, **changes)

    @property
    def intr(self) -> torch.Tensor:
        """[4] float32 (fx, fy, cx, cy)."""
        return torch.stack([self.fx, self.fy, self.cx, self.cy]).to(torch.float32)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _obs_poses(R, t, ci):
    """Per-observation (Rc [P,K,3,3], tc [P,K,3]): the 12 pose floats of
    each observation's camera, through ``cam_broadcast``.  ``ci`` [P,K]
    int32 is cam_idx already clipped to [0, C) (``CamCSR.ci``)."""
    C = R.shape[0]
    P, K = ci.shape
    Rt = ba_kernels.cam_broadcast(
        torch.cat([R.reshape(C, 9), t], dim=-1).contiguous(), ci.reshape(-1)
    )
    return Rt[:, :9].reshape(P, K, 3, 3), Rt[:, 9:].reshape(P, K, 3)


def pcg_transitions(cam_idx, C: int):
    """(broadcast, reduce): the camera <-> observation transition operators
    of the PCG branch, counterpart of the reference's
    ``_pcg_transitions_pallas``: ids clipped to [0, C);
    ``broadcast(v [C,F]) -> [E,F]`` is ``cam_broadcast`` and
    ``reduce(y [E,F]) -> [C,F]`` is ``cam_reduce`` (its CSR built once here).

    ``ba_solve`` does not use them: its fused ``normal_blocks`` /
    ``schur_ops`` kernels do the camera sums, as the reference's solve
    ignores the transitions when its fused kernels run.  The GBA profiling
    path (``profile_gba``) does."""
    ci = cam_idx.reshape(-1).clamp(0, C - 1).to(torch.int32).contiguous()
    csr = ba_kernels.reduce_csr(ci, C) if ci.device.type == "cuda" else None

    def broadcast(v):
        return ba_kernels.cam_broadcast(v.contiguous(), ci)

    def reduce(y):
        return ba_kernels.cam_reduce(y.contiguous(), ci, C, csr=csr)

    return broadcast, reduce


def _residuals_and_weights(prob: BAProblem, ci, R, t, X, huber_delta, use_huber=True):
    """Per-obs residuals r [P,K,2], robust*info weights w [P,K], chi2 [P,K],
    the validity mask, and the per-obs camera rotation Rc; ``ci`` as in
    ``_obs_poses``."""
    Rc, tc = _obs_poses(R, t, ci)
    r, Xc, w, chi2, valid = reproj.obs_residuals(
        Rc, tc, X, prob.point_valid, prob.uv, prob.sigma2, prob.obs_valid, prob.intr,
        huber_delta, use_huber,
    )
    return r, Xc, w, chi2, valid, Rc


def _cost(prob: BAProblem, R, t, X, huber_delta):
    """Huber reprojection cost of a state (``ba_kernels.reproj_cost``)."""
    return ba_kernels.reproj_cost(
        R, t, X, prob.point_valid, prob.cam_idx, prob.uv, prob.sigma2, prob.obs_valid,
        prob.intr, huber_delta,
    )


def _build_normal_blocks(prob: BAProblem, R, t, X, huber_delta, csr):
    """(U [C,6,6], V [P,3,3], W [P,K,6,3], g_c [C,6], g_p [P,3], cost)."""
    return ba_kernels.normal_blocks(
        R, t, X, prob.point_valid, prob.cam_idx, prob.uv, prob.sigma2, prob.obs_valid,
        prob.cam_fixed, prob.intr, huber_delta, csr,
    )


def inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def inv6x6_spd(A):
    """Closed-form batched 6x6 SPD inverse via the 3x3 block Schur complement:

        A = [[P, Q], [Q^T, S]];  Pi = P^-1;  T = (S - Q^T Pi Q)^-1
        A^-1 = [[Pi + Pi Q T Q^T Pi, -Pi Q T], [-T Q^T Pi, T]]
    """
    Pb = A[..., :3, :3]
    Qb = A[..., :3, 3:]
    Sb = A[..., 3:, 3:]
    Pi = inv3x3(Pb)
    PiQ = Pi @ Qb
    T = inv3x3(Sb - Qb.transpose(-1, -2) @ PiQ)
    TQtPi = T @ PiQ.transpose(-1, -2)
    top = torch.cat([Pi + PiQ @ TQtPi, -PiQ @ T], dim=-1)
    bot = torch.cat([-TQtPi, T], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _damp(M, lam):
    """M + (lam diag(M) + 1e-8) on the diagonal (multiplicative damping with
    an additive floor for empty blocks)."""
    n = M.shape[-1]
    return M + (lam * torch.diagonal(M, dim1=-2, dim2=-1) + 1e-8)[..., :, None] * _eye(n, M)


def _schur_system(U_d, Vinv, W, g_c, g_p, ci):
    """The dense reduced camera system of damped blocks:
    (S [6C,6C], b [C,6]) = (U_d - W Vinv W^T, g_c - W Vinv g_p), through the
    reference's one-hot contraction to a dense coupling operator [C,P,6,3]."""
    C = U_d.shape[0]
    onehot = torch.nn.functional.one_hot(ci.long(), C).to(U_d.dtype)  # [P,K,C]
    Wfull = torch.einsum("pkc,pkij->cpij", onehot, W)
    WV = torch.einsum("cpij,pjk->cpik", Wfull, Vinv)  # [C,P,6,3]
    S = -torch.einsum("cpik,dpjk->cidj", WV, Wfull)   # [C,6,C,6]
    ar = torch.arange(C, device=U_d.device)
    S[ar, :, ar, :] += U_d
    b = g_c - torch.einsum("cpik,pk->ci", WV, g_p)
    return S.reshape(C * 6, C * 6), b


def _solve_schur(prob: BAProblem, U, V, W, g_c, g_p, ci, lam):
    """One damped dense Schur solve: returns (delta_c [C,6], delta_p [P,3])."""
    C = U.shape[0]
    Vinv = inv3x3(_damp(V, lam))  # [P,3,3]
    S, b = _schur_system(_damp(U, lam), Vinv, W, g_c, g_p, ci)
    # inactive cameras (fixed or unobserved): unit diagonal so the solve is well-posed
    diag_mag = torch.diagonal(S)
    inactive = torch.repeat_interleave(prob.cam_fixed, 6) | (diag_mag <= 1e-7)
    eye = _eye(C * 6, S)
    S = torch.where(torch.diag_embed(inactive), eye, S)
    S = S + 1e-8 * eye
    b = torch.where(inactive.reshape(C, 6), 0.0, b)

    # S is SPD after damping; a failed factorization gives a non-finite step
    # (rejected by LM) as in the reference, instead of raising
    L, info = torch.linalg.cholesky_ex(S)
    delta_c = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(C, 6)
    delta_c = torch.where(info == 0, delta_c, float("nan"))
    delta_c = torch.where(prob.cam_fixed[:, None], 0.0, delta_c)
    return delta_c, _back_substitute(prob, Vinv, W, g_p, delta_c, ci)


def _back_substitute(prob: BAProblem, Vinv, W, g_p, delta_c, ci):
    """The dense branch's landmark step, the reference's gather form:
    delta_p = Vinv (g_p - sum_k W_pk^T delta_c[ci_pk]) [P,3], 0 on invalid
    landmarks."""
    Wt_dc = torch.einsum("pkij,pki->pj", W, delta_c[ci.long()])
    delta_p = torch.einsum("pij,pj->pi", Vinv, g_p - Wt_dc)
    return torch.where(prob.point_valid[:, None], delta_p, 0.0)


def _solve_schur_pcg(prob: BAProblem, U, V, W, g_c, g_p, csr, lam, x0,
                     cg_iters: int = 16, cg_rel_tol: float = 1e-2, sum_cams=None):
    """Matrix-free Schur solve for large camera counts.

        (S v)_c = U_d,c v_c - sum_{p,k2} 1[ci_pk2=c] W_pk2 V_p^-1
                  sum_k1 W_pk1^T v_{ci_pk1}

    applied per observation by the ``schur_ops`` kernels; block-Jacobi
    preconditioning with U_d^-1; warm start from the previous LM step;
    inexact-Newton stop at ``cg_rel_tol`` relative residual (LM's exact-cost
    accept gate absorbs the truncation).  The stopping test reads the
    residual on the host: one sync per CG step.

    ``sum_cams`` (the landmark-sharded solve, ``parallel.dist_ba``) sums
    the off-diagonal product and the right-hand side's correction, each a
    [C,6] camera vector of this shard's observations, over the shards.
    """
    sum_cams = sum_cams or (lambda x: x)
    U_d = _damp(U, lam)
    Vinv = inv3x3(_damp(V, lam))
    active = ~prob.cam_fixed & (torch.diagonal(U_d, dim1=-2, dim2=-1).sum(-1) > 1e-6)
    act = active[:, None]

    off_mv, rhs_op, wtv_op = ba_kernels.schur_ops(W, Vinv, csr)

    def S_mv(v):
        v = torch.where(act, v, 0.0)
        out = torch.einsum("cij,cj->ci", U_d, v) - sum_cams(off_mv(v))
        return torch.where(act, out, v)

    b = g_c - sum_cams(rhs_op(torch.einsum("pij,pj->pi", Vinv, g_p).contiguous()))
    b = torch.where(act, b, 0.0)

    Uinv = inv6x6_spd(U_d + 1e-6 * _eye(6, U_d))

    def M_inv(r):
        return torch.where(act, torch.einsum("cij,cj->ci", Uinv, r), r)

    x = torch.where(act, x0, 0.0)
    r = b - S_mv(x)
    z = M_inv(r)
    p = z
    rz = torch.sum(r * z)
    stop2 = (cg_rel_tol * cg_rel_tol) * torch.sum(b * b) + 1e-30
    for _ in range(cg_iters):
        if not bool(torch.sum(r * r) > stop2):  # host sync
            break
        Ap = S_mv(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20, 1e-20, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
        rz = rz_new
    delta_c = torch.where(prob.cam_fixed[:, None], 0.0, x)

    delta_p = torch.einsum("pij,pj->pi", Vinv, g_p - wtv_op(delta_c.contiguous()))
    delta_p = torch.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p


def ba_solve(prob: BAProblem, iters: int = 20, huber_delta: float = 2.447651936,
             cg_iters: int = 16, with_stats: bool = True, state=None,
             return_state: bool = False):
    """Run `iters` LM iterations.  Returns (R, t, X, final_cost, n_good_obs),
    plus the LM carry state ``(lam, dc, cost)`` when ``return_state=True``.

    Interruptibility: call with a small `iters` chunk and
    ``return_state=True``, check for fresh data on the host, and re-invoke on
    the updated problem passing the returned ``state`` -- lam, the CG warm
    start and the entry cost carry over, so a chunked solve follows the same
    LM path as a monolithic one.  Discard ``state`` whenever the problem
    changes between chunks (the carried cost would be stale).

    ``cg_iters`` caps the inner PCG solve (truncated, inexact-Newton steps;
    every step is gated on the exact cost).  ``with_stats=False`` skips the
    inlier count (n_good = -1), for chunks other than the last.
    """
    C = prob.R.shape[0]
    dev = prob.R.device
    use_pcg = C > pcg_min_c()
    csr = ba_kernels.cam_csr(prob.cam_idx, C)

    def cost_fn(R, t, X):
        return _cost(prob, R, t, X, huber_delta)

    if state is None:
        lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
        dc_prev = torch.zeros(C, 6, dtype=torch.float32, device=dev)
        cost = cost_fn(prob.R, prob.t, prob.X)
    else:
        lam, dc_prev, cost_in = state
        cost = torch.where(torch.isfinite(cost_in), cost_in, cost_fn(prob.R, prob.t, prob.X))

    R, t, X = prob.R, prob.t, prob.X
    for _ in range(iters):
        U, V, W, g_c, g_p, _ = _build_normal_blocks(prob, R, t, X, huber_delta, csr)
        if use_pcg:
            delta_c, delta_p = _solve_schur_pcg(
                prob, U, V, W, g_c, g_p, csr, lam, dc_prev, cg_iters=cg_iters
            )
        else:
            delta_c, delta_p = _solve_schur(prob, U, V, W, g_c, g_p, csr.ci, lam)

        dR, dt = se3_exp(delta_c)
        R_new = orthonormalize(dR @ R)  # keep the iterate on SO(3)
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = X + delta_p

        cost_new = cost_fn(R_new, t_new, X_new)
        finite = (
            torch.isfinite(delta_c).all() & torch.isfinite(delta_p).all()
            & torch.isfinite(cost_new)
        )
        accept = (cost_new < cost) & finite
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-10),
                          torch.clamp(lam * 5.0, max=1e8))
        dc_prev = torch.where(finite, delta_c, 0.0)

    # the carried cost IS the exact cost of the accepted final state
    if with_stats:
        _, _, _, chi2, valid, _ = _residuals_and_weights(prob, csr.ci, R, t, X, huber_delta)
        n_good = torch.sum((chi2 <= reproj.CHI2_MONO) & valid)
    else:
        n_good = torch.tensor(-1, dtype=torch.int64, device=dev)
    if return_state:
        return R, t, X, cost, n_good, (lam, dc_prev, cost)
    return R, t, X, cost, n_good


def classify_outliers(prob: BAProblem, R, t, X, chi2_thres: float = reproj.CHI2_MONO):
    """Post-solve chi2 gate per observation (local BA's final outlier pass)."""
    ci = prob.cam_idx.clamp(0, R.shape[0] - 1).contiguous()
    _, _, _, chi2, valid, _ = _residuals_and_weights(
        prob, ci, R, t, X, huber_delta=1.0, use_huber=False
    )
    return valid & (chi2 <= chi2_thres)
