"""Trajectory evaluation: camera centres and ATE after alignment (PyTorch).

Counterpart of ``camera_centers`` and ``ate_rmse`` of
``ccm_slam_tpu/io/trajectory.py`` (the evo ATE protocol, readme.md:185-194:
Sim(3) alignment, then the RMSE of translation).  The TUM / EuRoC writers are
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def camera_centers(R_cw, t_cw):
    """World positions of the camera: O_w = -R^T t. [...,3]"""
    return -torch.einsum("...ij,...i->...j", R_cw, t_cw)


def umeyama_alignment(P1, P2, fix_scale: bool = False):
    """Closed-form (s, R, t) minimizing sum |P1 - (s R P2 + t)|^2 over
    [N,3] correspondences (Umeyama's SVD solution, uniform weights)."""
    w = torch.full(P1.shape[:-1], 1.0 / P1.shape[-2], dtype=P1.dtype, device=P1.device)
    mu1 = torch.sum(P1 * w[..., None], dim=-2)
    mu2 = torch.sum(P2 * w[..., None], dim=-2)
    Q1 = P1 - mu1[..., None, :]
    Q2 = P2 - mu2[..., None, :]
    Sigma = torch.einsum("...ni,...nj,...n->...ij", Q1, Q2, w)
    U, D, Vt = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U @ Vt)
    S_fix = torch.cat([torch.ones((*det.shape, 2), dtype=P1.dtype, device=P1.device),
                       torch.sign(det)[..., None]], dim=-1)
    R = (U * S_fix[..., None, :]) @ Vt
    var2 = torch.sum(torch.sum(Q2 * Q2, dim=-1) * w, dim=-1)
    s = torch.ones_like(var2) if fix_scale else \
        torch.sum(D * S_fix, dim=-1) / torch.clamp(var2, min=1e-12)
    t = mu1 - s[..., None] * (R @ mu2[..., None])[..., 0]
    return s, R, t


def ate_rmse(est_pos, gt_pos, align: str = "sim3"):
    """Absolute trajectory error after alignment (evo_ape ... -vas).

    est_pos, gt_pos: [N,3] matched positions; align 'sim3' | 'se3' | 'none'.
    Returns (rmse, aligned_est as numpy)."""
    est = torch.as_tensor(np.asarray(est_pos, np.float32))
    gt = torch.as_tensor(np.asarray(gt_pos, np.float32))
    if align != "none":
        s, R, t = umeyama_alignment(gt, est, fix_scale=(align == "se3"))
        est = s * (est @ R.T) + t
    err = torch.linalg.norm(est - gt, dim=-1)
    return float(torch.sqrt(torch.mean(err ** 2))), est.numpy()
