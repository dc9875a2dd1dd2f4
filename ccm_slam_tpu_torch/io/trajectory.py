"""Trajectory output and ATE evaluation (PyTorch).

Counterpart of ``ccm_slam_tpu/io/trajectory.py``: the reference's
``Map::WriteStateToCsv`` (cslam/src/Map.cpp:1610-1670; TUM and EuRoC
formats, optionally in the body frame through T_SC) and the evo ATE protocol
(readme.md:185-194: Sim(3) alignment, then the RMSE of translation; the
alignment is ``solvers.sim3.umeyama_alignment``).  The writers take numpy
arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.sim3 import umeyama_alignment
from ..utils.lie import rot_to_quat


def camera_centers(R_cw, t_cw):
    """World positions of the camera: O_w = -R^T t. [...,3]"""
    return -torch.einsum("...ij,...i->...j", R_cw, t_cw)


def rot_cw_to_quat_wc(R_cw):
    """World->camera rotations -> camera->world quaternions (w, x, y, z)."""
    return rot_to_quat(torch.as_tensor(R_cw).transpose(-1, -2))


def _poses_wc(R_cw, t_cw, t_sc):
    """(centres [N,3], quaternions wxyz [N,4]) of T_wc, or of the body pose
    T_WS = T_WC o T_SC^-1 when ``t_sc`` (4x4, camera -> body) is given."""
    R_cw = torch.as_tensor(np.asarray(R_cw, np.float32))
    t_cw = torch.as_tensor(np.asarray(t_cw, np.float32))
    R_wc = R_cw.transpose(-1, -2).numpy()
    centers = camera_centers(R_cw, t_cw).numpy()
    if t_sc is not None:
        T_sc = np.asarray(t_sc)
        R_sc, p_sc = T_sc[:3, :3], T_sc[:3, 3]
        # T_SC^-1 = (R_sc^T, -R_sc^T p_sc)
        centers = centers - np.einsum("nij,j->ni", R_wc @ R_sc.T, p_sc)
        R_wc = R_wc @ R_sc.T
    return centers, rot_to_quat(torch.as_tensor(R_wc.astype(np.float32))).numpy()


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_tum(path, timestamps, R_cw, t_cw, t_sc=None):
    """TUM format: ``stamp tx ty tz qx qy qz qw`` of T_wc (or of the body
    pose through T_SC)."""
    centers, quats = _poses_wc(_host(R_cw), _host(t_cw), t_sc)
    with open(path, "w") as f:
        for ts, c, q in zip(_host(timestamps), centers, quats):
            f.write(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def write_euroc(path, timestamps, R_cw, t_cw, t_sc=None):
    """EuRoC state-estimate csv: ``ts_ns,px,py,pz,qw,qx,qy,qz,v*,bg*,ba*``
    with zero velocity and bias columns (the reference's trajectory format
    0, cslam/src/Map.cpp:1652-1658; TUM is format 1)."""
    centers, quats = _poses_wc(_host(R_cw), _host(t_cw), t_sc)
    zeros = "0.0,0.0,0.0"
    with open(path, "w") as f:
        for ts, c, q in zip(_host(timestamps), centers, quats):
            f.write(f"{float(ts) * 1e9:.0f},{c[0]:.7f},{c[1]:.7f},{c[2]:.7f},"
                    f"{q[0]:.7f},{q[1]:.7f},{q[2]:.7f},{q[3]:.7f},"
                    f"{zeros},{zeros},{zeros}\n")


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
