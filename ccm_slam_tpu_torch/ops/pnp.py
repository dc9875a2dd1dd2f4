"""Batched PnP (absolute pose from 2D-3D matches) with RANSAC (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/pnp.py``: hypotheses are 6-point DLT
poses evaluated in one batch, the winner refined by the pose optimizer
(``solvers/pose_opt.optimize_pose``) against all candidate matches.

RANSAC samples are an input, ``idx [n,6]`` (the tests pass the JAX key's
draws); without it they are drawn in proportion to ``valid`` from
``generator`` (``initializer.draw_samples``).
"""

from __future__ import annotations

import torch

from ..solvers import pose_opt
from .initializer import draw_samples


def _proper_rotation(U, Vt):
    """U diag(1, 1, det(U Vt)) Vt, and that det: the nearest rotation."""
    det = torch.linalg.det(U @ Vt)
    ones = torch.ones_like(det)
    return U @ torch.diag_embed(torch.stack([ones, ones, det], dim=-1)) @ Vt, det


def _dlt_pose(X, uv_norm):
    """6+-point DLT for P = [R|t] per hypothesis: X [B,n,3] world points,
    uv_norm [B,n,2] normalized image coords.  Returns (R [B,3,3], t [B,3])."""
    n = X.shape[-2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    u, v = uv_norm[..., 0:1], uv_norm[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [B,2n,12]
    P = torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :].reshape(*A.shape[:-2], 3, 4)
    # orthogonalize: M = s R with R in SO(3)
    U, D, Vt2 = torch.linalg.svd(P[..., :3])
    R, det = _proper_rotation(U, Vt2)
    ones = torch.ones_like(det)
    s = torch.sum(D * torch.stack([ones, ones, det], dim=-1), dim=-1) / 3.0
    s = torch.where(torch.abs(s) < 1e-12, 1e-12, s)
    t = P[..., 3] / s[..., None]
    # cheirality: a majority of the points must be in front
    z = (X @ R.transpose(-1, -2))[..., 2] + t[..., 2:3]
    flip = torch.sum(z > 0, dim=-1) < (n // 2)
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # -R is not a rotation (det = -1): repair via SVD again
    U3, _, Vt3 = torch.linalg.svd(R)
    R, _ = _proper_rotation(U3, Vt3)
    return R, t


def ransac_pnp(X, uv, valid, sigma2, fx, fy, cx, cy, n_hypotheses: int = 200,
               inlier_chi2: float = 5.991, refine: bool = True, idx=None, generator=None):
    """RANSAC absolute-pose estimation.

    X [N,3] world points matched to undistorted pixels uv [N,2]; valid [N];
    sigma2 [N].  idx [n,6]: RANSAC samples (drawn from ``generator`` when
    absent).  Returns dict(success, R, t, inliers [N], n_inliers)."""
    uv_norm = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=1)
    if idx is None:
        idx = draw_samples(valid, n_hypotheses, 6, generator)
    idx = idx.long()
    R_h, t_h = _dlt_pose(X[idx], uv_norm[idx])

    # reprojection chi2 of every match under every hypothesis
    Xc = torch.einsum("hij,nj->hni", R_h, X) + t_h[:, None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    chi2 = ((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2) / sigma2[None, :]
    inl = valid[None, :] & (chi2 < inlier_chi2) & (z > 0)
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    R_b, t_b, inl_b = R_h[best], t_h[best], inl[best]

    if refine:
        # refine against all candidate matches: the optimizer's chi2 rounds
        # reclaim inliers the minimal sample missed
        R_b, t_b, inl_b, n_in = pose_opt.optimize_pose(
            R_b, t_b, X, uv, valid, sigma2, fx, fy, cx, cy, rounds=3, iters_per_round=10)
    else:
        n_in = counts[best]
    return {"success": n_in >= 10, "R": R_b, "t": t_b, "inliers": inl_b, "n_inliers": n_in}
