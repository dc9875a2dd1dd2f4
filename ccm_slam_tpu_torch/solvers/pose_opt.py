"""Pose-only bundle adjustment (the per-frame tracking optimizer), PyTorch.

Counterpart of ``ccm_slam_tpu/solvers/pose_opt.py``: optimize one camera pose
against its frame's map-point associations with 4 rounds x 10 LM iterations,
re-classifying observations as in/outliers after each round with the
chi2(0.95, 2 dof) gate and a positive-depth test, and dropping the Huber
kernel in the final round.

The frame's N feature slots enter as dense tensors with a validity mask; each
LM iteration is one 6x6 solve.  Accept/reject is a ``torch.where`` select, so
the 40 iterations run without a host round-trip.  No kernel of its own: the
work is a few hundred floats per iteration.
"""

from __future__ import annotations

import torch

from ..utils.lie import orthonormalize, se3_exp
from . import reproj


def _gauss_newton_system(R, t, X, uv, w_conf, fx, fy, cx, cy, huber_delta, use_huber):
    """Weighted normal equations H (6x6), b (6), per-obs chi2, depth z."""
    r, Xc, z = reproj.project_residual(R, t, X, uv, fx, fy, cx, cy)
    J, _ = reproj.pose_point_jacobians(R, Xc, fx, fy)  # [N,2,6]
    chi2 = w_conf * torch.sum(r * r, dim=-1)  # information-weighted squared error
    w_rob = reproj.huber_weight(chi2, huber_delta) if use_huber else 1.0
    w = w_conf * w_rob  # [N]
    # H = sum J^T w J ; b = -sum J^T w r
    Jw = J * w[:, None, None]
    H = torch.einsum("nij,nik->jk", Jw, J)
    b = -torch.einsum("nij,ni->j", Jw, r)
    return H, b, chi2, z


def _robust_cost(chi2, huber_delta, use_huber):
    return torch.sum(reproj.huber_rho(chi2, huber_delta) if use_huber else chi2)


def optimize_pose(
    R0,
    t0,
    X,
    uv,
    valid,
    sigma2,
    fx,
    fy,
    cx,
    cy,
    rounds: int = 4,
    iters_per_round: int = 10,
    chi2_thres: float = reproj.CHI2_MONO,
    huber_delta: float = 2.447651936,
):
    """Optimize T_cw = (R0, t0) against point-pixel associations.

    Args:
      R0 [3,3], t0 [3]; X [N,3] world points; uv [N,2] undistorted pixels;
      valid [N] bool association mask; sigma2 [N] per-obs detection variance.
      All tensors on one device (the caller's choice).
    Returns:
      (R, t, inlier_mask [N], n_inliers) -- inlier_mask marks associations
      that pass the chi2 gate at the final pose.
    """
    w_conf0 = torch.where(valid, 1.0 / sigma2, 0.0)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    R = orthonormalize(R0)
    t = t0
    inlier = valid.to(X.dtype)
    for round_idx in range(rounds):
        use_huber = round_idx < rounds - 1  # final round: plain least squares
        lam = torch.tensor(1e-3, dtype=X.dtype, device=X.device)
        w_conf = w_conf0 * inlier
        for _ in range(iters_per_round):
            H, b, chi2, _ = _gauss_newton_system(
                R, t, X, uv, w_conf, fx, fy, cx, cy, huber_delta, use_huber
            )
            chi2 = chi2 * (w_conf > 0)  # masked slots contribute nothing
            cost = _robust_cost(chi2, huber_delta, use_huber)
            H_damped = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = torch.linalg.solve(H_damped, b)
            dR, dt = se3_exp(dx)
            R_new = dR @ R
            t_new = (dR @ t[..., None])[..., 0] + dt
            # evaluate trial cost
            r_new, _, _ = reproj.project_residual(R_new, t_new, X, uv, fx, fy, cx, cy)
            chi2_new = w_conf * torch.sum(r_new * r_new, dim=-1)
            cost_new = _robust_cost(chi2_new, huber_delta, use_huber)
            accept = (cost_new < cost) & torch.all(torch.isfinite(dx))
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            lam = torch.where(
                accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6)
            )
        # keep R on SO(3): the dR @ R chain preserves any non-orthogonal defect
        R = orthonormalize(R)
        # re-classify at the updated pose (chi2 > 5.991 or depth <= 0: outlier)
        r, _, z = reproj.project_residual(R, t, X, uv, fx, fy, cx, cy)
        chi2 = w_conf0 * torch.sum(r * r, dim=-1)
        inlier = (valid & (chi2 <= chi2_thres) & (z > 0)).to(X.dtype)

    inlier_mask = inlier > 0.5
    return R, t, inlier_mask, torch.sum(inlier_mask.to(torch.int32))
