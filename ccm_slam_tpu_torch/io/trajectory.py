"""Trajectory evaluation: camera centres and ATE after alignment (PyTorch).

Counterpart of ``camera_centers`` and ``ate_rmse`` of
``ccm_slam_tpu/io/trajectory.py`` (the evo ATE protocol, readme.md:185-194:
Sim(3) alignment, then the RMSE of translation); the alignment is
``solvers.sim3.umeyama_alignment``.  The TUM / EuRoC writers are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.sim3 import umeyama_alignment


def camera_centers(R_cw, t_cw):
    """World positions of the camera: O_w = -R^T t. [...,3]"""
    return -torch.einsum("...ij,...i->...j", R_cw, t_cw)


def ate_rmse(est_pos, gt_pos, align: str = "sim3"):
    """Absolute trajectory error after alignment (evo_ape ... -vas).

    est_pos, gt_pos: [N,3] matched positions; align 'sim3' | 'se3' | 'none'.
    Returns (rmse, aligned_est as numpy)."""
    est = torch.as_tensor(np.asarray(est_pos, np.float32))
    gt = torch.as_tensor(np.asarray(gt_pos, np.float32))
    if align != "none":
        S = umeyama_alignment(gt, est, fix_scale=(align == "se3"))
        est = S.s * (est @ S.R.T) + S.t
    err = torch.linalg.norm(est - gt, dim=-1)
    return float(torch.sqrt(torch.mean(err ** 2))), est.numpy()
