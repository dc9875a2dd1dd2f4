"""Reprojection residuals, analytic Jacobians, and robust weights (PyTorch).

Counterpart of ``ccm_slam_tpu/solvers/reproj.py``: the measurement model
shared by every optimizer,

    r = pi(R_cw X_w + t_cw) - uv_observed          (2-vector, pixels)

with left-multiplicative tangent pose updates ``T_cw <- exp([rho, phi]) T_cw``
so the pose Jacobian has the closed form ``d(Xc)/d(xi) = [I | -hat(Xc)]``.
Per-observation information is ``1/sigma2`` with ``sigma2 = s^{2*octave}``.
"""

from __future__ import annotations

import torch

from ..utils.lie import hat

CHI2_MONO = 5.991  # 95% quantile of chi2 with 2 dof


def level_sigma2(octave, scale_factor: float = 1.2):
    """sigma^2 of the detection at a pyramid octave."""
    base = torch.tensor(scale_factor * scale_factor, dtype=torch.float32,
                        device=octave.device)
    return torch.pow(base, octave.to(torch.float32))


def _z_safe(z):
    return torch.where(torch.abs(z) < 1e-9, 1e-9, z)


def project_residual(R_cw, t_cw, X_w, uv, fx, fy, cx, cy):
    """Residual + camera-frame point.

    Shapes broadcast: R_cw [...,3,3], t_cw [...,3], X_w [...,3], uv [...,2].
    Returns (r [...,2], Xc [...,3], z [...]).
    """
    Xc = (R_cw @ X_w[..., None])[..., 0] + t_cw
    z = Xc[..., 2]
    z_safe = _z_safe(z)
    u = fx * Xc[..., 0] / z_safe + cx
    v = fy * Xc[..., 1] / z_safe + cy
    r = torch.stack([u, v], dim=-1) - uv
    return r, Xc, z


def proj_jacobian_point(Xc, fx, fy):
    """d(pi)/d(Xc): [..., 2, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / _z_safe(z)
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def pose_point_jacobians(R_cw, Xc, fx, fy):
    """(J_pose [...,2,6], J_point [...,2,3]) for the left-multiplicative
    pose parametrization [rho, phi] and world-point parametrization."""
    Jproj = proj_jacobian_point(Xc, fx, fy)  # [..., 2, 3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(*Xc.shape[:-1], 3, 3)
    dXc_dxi = torch.cat([eye, -hat(Xc)], dim=-1)  # [..., 3, 6]
    J_pose = Jproj @ dXc_dxi  # [..., 2, 6]
    J_point = Jproj @ R_cw  # [..., 2, 3]
    return J_pose, J_point


def huber_weight(chi2, delta: float):
    """IRLS weight of the Huber kernel applied to chi2 (g2o convention:
    kernel delta given on the residual scale, threshold at delta^2)."""
    d2 = delta * delta
    safe = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= d2, 1.0, delta / safe)


def huber_rho(chi2, delta: float):
    """Huber cost rho(chi2) for monitoring/accept decisions."""
    d2 = delta * delta
    return torch.where(
        chi2 <= d2, chi2, 2.0 * delta * torch.sqrt(torch.clamp(chi2, min=0.0)) - d2
    )


def obs_residuals(Rc, tc, X, point_valid, uv, sigma2, obs_valid, intr, huber_delta,
                  use_huber=True):
    """Per-observation (r [P,K,2], Xc [P,K,3], w [P,K], chi2 [P,K], valid)
    of a [P,K] observation table, given each observation's pose Rc
    [P,K,3,3], tc [P,K,3] (the reference's ``ba._residuals_and_weights``).

    valid = obs_valid & point_valid & z > 1e-6; w = (1/sigma2) * Huber IRLS
    weight on valid observations, 0 elsewhere."""
    fx, fy, cx, cy = intr.unbind()
    r, Xc, z = project_residual(Rc, tc, X[:, None, :], uv, fx, fy, cx, cy)
    valid = obs_valid & point_valid[:, None] & (z > 1e-6)
    w_conf = torch.where(valid, 1.0 / sigma2, 0.0)
    chi2 = w_conf * torch.sum(r * r, dim=-1)
    w_rob = huber_weight(chi2, huber_delta) if use_huber else 1.0
    return r, Xc, w_conf * w_rob, chi2, valid
