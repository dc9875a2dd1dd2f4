"""Sim(3) estimation: closed-form alignment, batched RANSAC, pair refinement
(PyTorch).

Counterpart of ``ccm_slam_tpu/solvers/sim3.py`` (the reference's
``Sim3Solver``, cslam/src/Sim3Solver.cpp, and ``Optimizer::OptimizeSim3``,
cslam/src/Optimizer.cpp:861-1056): every RANSAC hypothesis is evaluated at
once along a leading batch axis.

Randomness: ``ransac_sim3`` takes its samples ``idx [H, 3]`` as an input, or
draws them from ``generator`` (``initializer.draw_samples``: uniform over the
valid correspondences, as the reference's ``jax.random.categorical`` over
``log(valid)``).  Ties: the best hypothesis is the first with the most
inliers (``torch.argmax`` returns the first maximum, as ``jnp.argmax``).
The refinement's Jacobian is forward-mode AD (``torch.func.jvp``, the seven
tangent directions batched along the hypothesis axis) where the reference
takes ``jax.jacobian``; 7x7 systems go through ``torch.linalg.solve_ex``, so
a singular system gives a non-finite step (rejected by the LM gate) as in
the reference instead of raising.
"""

from __future__ import annotations

import torch

from ..ops.initializer import draw_samples
from ..utils.lie import Sim3
from . import reproj


def umeyama_alignment(P1, P2, weights=None, fix_scale: bool = False) -> Sim3:
    """Closed-form s, R, t minimizing sum w |P1 - (s R P2 + t)|^2.

    P1, P2: [..., N, 3] correspondences; weights [..., N] (uniform when
    None).  Returns a Sim3 batched over the leading dims (Umeyama's SVD
    solution, the minimizer of the reference's Horn method)."""
    if weights is None:
        weights = torch.ones(P1.shape[:-1], dtype=P1.dtype, device=P1.device)
    w = weights / torch.clamp(torch.sum(weights, -1, keepdim=True), min=1e-12)
    mu1 = torch.sum(P1 * w[..., None], dim=-2)
    mu2 = torch.sum(P2 * w[..., None], dim=-2)
    Q1 = P1 - mu1[..., None, :]
    Q2 = P2 - mu2[..., None, :]
    # covariance of P2 -> P1
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
    return Sim3(s=s, R=R, t=t)


def _pinhole(Xc, fx, fy, cx, cy):
    """Pixels of camera-frame points (depth clamped away from 0 as the
    reference does) and their depth."""
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return torch.stack([fx * Xc[..., 0] / z_safe + cx, fy * Xc[..., 1] / z_safe + cy], -1), z


def _reproj_err2(S: Sim3, P_src, uv_dst, fx, fy, cx, cy):
    """Squared pixel error of projecting S(P_src) with a pinhole (the points
    are in the destination camera's frame after S), and the depth."""
    uv, z = _pinhole(S.apply(P_src), fx, fy, cx, cy)
    d = uv - uv_dst
    return torch.sum(d * d, dim=-1), z


def ransac_sim3(Xc1, Xc2, uv1, uv2, valid, max_err1, max_err2, fx, fy, cx, cy,
                n_hypotheses: int = 300, fix_scale: bool = False, idx=None,
                generator=None):
    """Batched RANSAC for the Sim3 aligning camera-frame point sets.

    Xc1/Xc2 [N,3]: the same landmarks in KF1's / KF2's camera frame; uv1/uv2
    [N,2] their observed pixels; max_err* [N] per-observation squared-pixel
    gates (9.210 sigma^2).  ``idx`` [H,3]: the hypotheses' sample indices
    (else drawn from ``generator``).

    Returns (S12: Sim3, inliers [N] bool, n_inliers)."""
    if idx is None:
        idx = draw_samples(valid, n_hypotheses, 3, generator=generator)
    idx = idx.long()
    S_h = umeyama_alignment(Xc1[idx], Xc2[idx], fix_scale=fix_scale)  # batched over H

    # inlier check in both images (Sim3Solver::CheckInliers)
    e1, z1 = _reproj_err2(S_h, Xc2[None], uv1[None], fx, fy, cx, cy)  # [H,N]
    e2, z2 = _reproj_err2(S_h.inverse(), Xc1[None], uv2[None], fx, fy, cx, cy)
    inl = valid[None] & (e1 < max_err1[None]) & (e2 < max_err2[None]) & (z1 > 0) & (z2 > 0)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)

    # refine on the best hypothesis' inliers with a weighted closed-form fit
    S_ref = umeyama_alignment(Xc1, Xc2, weights=inl[best].to(torch.float32),
                              fix_scale=fix_scale)
    e1r, z1r = _reproj_err2(S_ref, Xc2, uv1, fx, fy, cx, cy)
    e2r, z2r = _reproj_err2(S_ref.inverse(), Xc1, uv2, fx, fy, cx, cy)
    inl_ref = valid & (e1r < max_err1) & (e2r < max_err2) & (z1r > 0) & (z2r > 0)
    # keep whichever of (refined, raw-best) has more inliers
    better = torch.sum(inl_ref) >= counts[best]
    S_b = S_h[best]
    S_out = Sim3(s=torch.where(better, S_ref.s, S_b.s), R=torch.where(better, S_ref.R, S_b.R),
                 t=torch.where(better, S_ref.t, S_b.t))
    inl_out = torch.where(better, inl_ref, inl[best])
    return S_out, inl_out, torch.sum(inl_out)


def optimize_sim3(S12_init: Sim3, Xc1, Xc2, uv1, uv2, valid, sigma2_1, sigma2_2, fx, fy,
                  cx, cy, iters: int = 10, huber_delta: float = 3.1622776601683795,
                  chi2_thres: float = 10.0, fix_scale: bool = False):
    """Joint LM refinement of the relative Sim3 (Optimizer::OptimizeSim3):
    Huber-robust reprojection of Xc2 through S12 into image 1 and of Xc1
    through S12^-1 into image 2; two rounds of ``iters`` steps with the
    chi2 gate between them.  Returns (S12, inliers [N], n_inliers)."""
    dev = Xc1.device
    w1 = torch.where(valid, 1.0 / sigma2_1, 0.0)
    w2 = torch.where(valid, 1.0 / sigma2_2, 0.0)
    keep = torch.ones(7, dtype=torch.float32, device=dev)
    if fix_scale:
        keep[6] = 0.0

    def residuals(xi):
        """xi [B,7] -> r1, r2 [B,N,2]."""
        S0 = Sim3(s=S12_init.s[None], R=S12_init.R[None], t=S12_init.t[None])
        S = Sim3.exp(xi).compose(S0)
        uv_1, _ = _pinhole(S.apply(Xc2[None]), fx, fy, cx, cy)
        uv_2, _ = _pinhole(S.inverse().apply(Xc1[None]), fx, fy, cx, cy)
        return uv_1 - uv1[None], uv_2 - uv2[None]

    def chi2(r1, r2):
        return w1 * torch.sum(r1 * r1, -1), w2 * torch.sum(r2 * r2, -1)

    def chi2_of(xi):
        r1, r2 = residuals(xi[None])
        return chi2(r1[0], r2[0])

    def cost(c1, c2, inlier):
        rho = reproj.huber_rho(c1, huber_delta) + reproj.huber_rho(c2, huber_delta)
        return torch.sum(rho * inlier)

    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def lm_round(xi, inlier):
        lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
        sw = torch.cat([torch.sqrt(w1 * inlier), torch.sqrt(w2 * inlier)])[:, None]  # [2N,1]
        for _ in range(iters):
            # the residuals and their 7 directional derivatives in one batched
            # forward-mode pass (row d of the batch carries the tangent e_d)
            (r1, r2), (d1, d2) = torch.func.jvp(residuals, (xi[None].repeat(7, 1),), (eye7,))
            c1, c2 = chi2(r1[0], r2[0])
            r = (torch.cat([r1[0], r2[0]]) * sw).reshape(-1)         # [4N]
            J = (torch.cat([d1, d2], 1) * sw).reshape(7, -1).T       # [4N,7]
            hw = torch.repeat_interleave(torch.cat([reproj.huber_weight(c1, huber_delta),
                                                    reproj.huber_weight(c2, huber_delta)]), 2)
            H = J.T @ (J * hw[:, None])
            b = -J.T @ (r * hw)
            if fix_scale:  # zero out the scale direction
                H = H * keep[None, :] * keep[:, None] + torch.diag(1.0 - keep)
                b = b * keep
            # additive identity floor in the damping (the reference's: nearly
            # co-located loop keyframes leave the scale unobservable)
            H = H + lam * (torch.diag(torch.diag(H)) + eye7)
            dx = torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
            xi_new = dx + xi
            ok = torch.all(torch.isfinite(dx))
            accept = (cost(*chi2_of(xi_new), inlier) < cost(c1, c2, inlier) * (1.0 - 1e-6)) & ok
            xi = torch.where(accept, xi_new, xi)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        return xi

    xi = lm_round(torch.zeros(7, dtype=torch.float32, device=dev), valid.to(torch.float32))
    # outlier gate, then a second round on the inliers only
    c1, c2 = chi2_of(xi)
    xi = lm_round(xi, (valid & (c1 <= chi2_thres) & (c2 <= chi2_thres)).to(torch.float32))
    c1, c2 = chi2_of(xi)
    inlier = valid & (c1 <= chi2_thres) & (c2 <= chi2_thres)
    S0 = Sim3(s=S12_init.s, R=S12_init.R, t=S12_init.t)
    return Sim3.exp(xi).compose(S0), inlier, torch.sum(inlier)
