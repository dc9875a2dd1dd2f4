"""Plain bundle adjustment: the semantics of the program's ``ba_solve``,
written out with gathers and ``index_add_`` in any floating type.

The same Levenberg-Marquardt loop (multiplicative damping of the diagonal
plus 1e-8, lambda from 1e-4, x0.3 on an accepted step and x5 on a rejected
one, an exact-cost accept gate), the same Huber-weighted reprojection model
(left-multiplicative SE(3) updates, pinhole projection, chi2 = r^T r /
sigma2), and the same two solvers of the reduced camera system: a dense
Schur complement with a Cholesky solve for C <= ``pcg_min_c``, and
block-Jacobi preconditioned CG on the Schur operator beyond it (warm start
from the previous step, at most ``cg_iters`` steps, stop at a relative
residual of 1e-2).  Matrix inverses are ``torch.linalg.inv`` and rotations
are projected onto SO(3) by SVD, where the program uses closed forms and
Newton-polar steps.

``solve`` runs in float64 as the reference.  In bfloat16 (its inverses,
Cholesky factors and SVDs through float32) it is the server GBA's control,
the precision below the configuration's float32 that the comparison has to
reject.
"""

from __future__ import annotations

import torch

HUBER = 2.447651936


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(xi):
    """[..., 6] (rho, phi) -> (R, t): Rodrigues and the left Jacobian V."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(phi * phi, -1)[..., None, None]
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2 < 1e-8
    k = _hat(phi)
    k2 = k @ k
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-30))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * k + b * k2
    V = eye + b * k + c * k2
    return R, (V @ rho[..., None])[..., 0]


def _wide(fn, *xs):
    """``fn`` of tensors in a type it takes (float32 for bfloat16), the
    result in the arguments' type."""
    lo = xs[0].dtype
    hi = torch.float32 if lo in (torch.bfloat16, torch.float16) else lo
    out = fn(*(x.to(hi) for x in xs))
    if isinstance(out, tuple):
        return tuple(o.to(lo) if o.is_floating_point() else o for o in out)
    return out.to(lo)


def inv(A):
    return _wide(torch.linalg.inv, A)


def nearest_rotation(R):
    def proj(R):
        U, _, Vh = torch.linalg.svd(R)
        return U @ Vh
    return _wide(proj, R)


def as_dtype(m, dtype):
    """A map (dict of tensors) with its floating tensors in ``dtype``."""
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in m.items()}


class Problem:
    """Observation-table BA over a map dict (``gen.gba_maps``' layout)."""

    def __init__(self, m, huber=HUBER):
        self.m, self.huber = m, huber
        self.C = m["R"].shape[0]
        self.P, self.K = m["cam_idx"].shape
        self.ci = m["cam_idx"].clamp(0, self.C - 1).long()
        self.flat = self.ci.reshape(-1)

    def residuals(self, R, t, X):
        m = self.m
        fx, fy, cx, cy = m["intr"].unbind()
        Rc = R[self.ci]
        Xc = torch.einsum("pkij,pj->pki", Rc, X) + t[self.ci]
        z = Xc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        r = torch.stack([fx * Xc[..., 0] / zs + cx, fy * Xc[..., 1] / zs + cy], -1) - m["uv"]
        valid = m["obs_valid"] & m["point_valid"][:, None] & (z > 1e-6)
        w_conf = torch.where(valid, 1.0 / m["sigma2"], 0.0)
        chi2 = w_conf * torch.sum(r * r, -1)
        return r, Xc, Rc, zs, valid, w_conf, chi2

    def rho(self, chi2):
        d2 = self.huber * self.huber
        return torch.where(chi2 <= d2, chi2,
                           2.0 * self.huber * torch.sqrt(torch.clamp(chi2, min=0.0)) - d2)

    def cost(self, R, t, X):
        return torch.sum(self.rho(self.residuals(R, t, X)[-1]))

    def blocks(self, R, t, X):
        """(U [C,6,6], V [P,3,3], W [P,K,6,3], g_c [C,6], g_p [P,3])."""
        m = self.m
        fx, fy = m["intr"][0], m["intr"][1]
        r, Xc, Rc, zs, _, w_conf, chi2 = self.residuals(R, t, X)
        w_rob = torch.where(chi2 <= self.huber ** 2, 1.0,
                            self.huber / torch.sqrt(torch.clamp(chi2, min=1e-12)))
        w = w_conf * w_rob
        iz = 1.0 / zs
        zero = torch.zeros_like(iz)
        Jproj = torch.stack([
            torch.stack([fx * iz, zero, -fx * Xc[..., 0] * iz * iz], -1),
            torch.stack([zero, fy * iz, -fy * Xc[..., 1] * iz * iz], -1)], -2)
        eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(*Xc.shape[:-1], 3, 3)
        Jc = Jproj @ torch.cat([eye, -_hat(Xc)], -1)
        Jp = Jproj @ Rc
        gate = (w > 0)[..., None, None].to(r.dtype)
        Jc = Jc * gate * (~m["cam_fixed"])[self.ci][..., None, None].to(r.dtype)
        Jp = Jp * gate
        wJc, wJp = Jc * w[..., None, None], Jp * w[..., None, None]
        V = torch.einsum("pkij,pkil->pjl", wJp, Jp)
        W = torch.einsum("pkij,pkil->pkjl", wJc, Jp)
        g_p = -torch.einsum("pkij,pki->pj", wJp, r)
        U = torch.zeros(self.C, 6, 6, dtype=r.dtype, device=r.device).index_add_(
            0, self.flat, torch.einsum("pkij,pkil->pkjl", wJc, Jc).reshape(-1, 6, 6))
        g_c = torch.zeros(self.C, 6, dtype=r.dtype, device=r.device).index_add_(
            0, self.flat, -torch.einsum("pkij,pki->pkj", wJc, r).reshape(-1, 6))
        return U, V, W, g_c, g_p

    def cam_sum(self, y):
        """[P,K,6] observation rows -> [C,6] camera sums."""
        out = torch.zeros(self.C, 6, dtype=y.dtype, device=y.device)
        return out.index_add_(0, self.flat, y.reshape(-1, 6))

    def wtv(self, W, v):
        """[P,3]: sum_k W_pk^T v[ci_pk]."""
        return torch.einsum("pkij,pki->pj", W, v[self.ci])


def _damp(M, lam):
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + torch.diag_embed(lam * d + 1e-8)


def _solve_dense(pb, U, V, W, g_c, g_p, lam):
    m, C = pb.m, pb.C
    Vinv = inv(_damp(V, lam))
    WV = torch.einsum("pkij,pjl->pkil", W, Vinv)  # [P,K,6,3]
    pair = torch.einsum("pail,pbjl->pabij", WV, W)  # [P,K,K,6,6]
    idx = (pb.ci[:, :, None] * C + pb.ci[:, None, :]).reshape(-1)
    S = torch.zeros(C * C, 6, 6, dtype=U.dtype, device=U.device).index_add_(
        0, idx, -pair.reshape(-1, 6, 6))
    S = S.reshape(C, C, 6, 6)
    ar = torch.arange(C, device=U.device)
    S[ar, ar] += _damp(U, lam)
    S = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    b = g_c - pb.cam_sum(torch.einsum("pkil,pl->pki", WV, g_p))
    inactive = torch.repeat_interleave(m["cam_fixed"], 6) | (torch.diagonal(S) <= 1e-7)
    dg = torch.diagonal(S)
    dg[inactive] = 1.0
    S = S + 1e-8 * torch.eye(6 * C, dtype=S.dtype, device=S.device)
    b = torch.where(inactive.reshape(C, 6), 0.0, b)
    L, info = _wide(torch.linalg.cholesky_ex, S)
    dc = _wide(torch.cholesky_solve, b.reshape(-1, 1), L).reshape(C, 6)
    dc = torch.where(info == 0, dc, float("nan"))
    dc = torch.where(m["cam_fixed"][:, None], 0.0, dc)
    dp = torch.einsum("pij,pj->pi", Vinv, g_p - pb.wtv(W, dc))
    return dc, torch.where(m["point_valid"][:, None], dp, 0.0)


def _solve_pcg(pb, U, V, W, g_c, g_p, lam, x0, cg_iters, tol=1e-2):
    m = pb.m
    U_d = _damp(U, lam)
    Vinv = inv(_damp(V, lam))
    act = (~m["cam_fixed"] & (torch.diagonal(U_d, dim1=-2, dim2=-1).sum(-1) > 1e-6))[:, None]

    def S_mv(v):
        v = torch.where(act, v, 0.0)
        y = torch.einsum("pij,pj->pi", Vinv, pb.wtv(W, v))
        out = torch.einsum("cij,cj->ci", U_d, v) - pb.cam_sum(torch.einsum("pkij,pj->pki", W, y))
        return torch.where(act, out, v)

    b = g_c - pb.cam_sum(torch.einsum("pkij,pj->pki", W, torch.einsum("pij,pj->pi", Vinv, g_p)))
    b = torch.where(act, b, 0.0)
    Uinv = inv(U_d + 1e-6 * torch.eye(6, dtype=U.dtype, device=U.device))

    def M_inv(r):
        return torch.where(act, torch.einsum("cij,cj->ci", Uinv, r), r)

    x = torch.where(act, x0, 0.0)
    r = b - S_mv(x)
    z = M_inv(r)
    p, rz = z, torch.sum(r * z)
    stop2 = tol * tol * torch.sum(b * b) + 1e-30
    steps = 0
    for _ in range(cg_iters):
        if not bool(torch.sum(r * r) > stop2):
            break
        steps += 1
        Ap = S_mv(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20, 1e-20, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz) * p
        rz = rz_new
    dc = torch.where(m["cam_fixed"][:, None], 0.0, x)
    dp = torch.einsum("pij,pj->pi", Vinv, g_p - pb.wtv(W, dc))
    return dc, torch.where(m["point_valid"][:, None], dp, 0.0), steps


def solve(m, iters=20, cg_iters=16, pcg_min_c=96, huber=HUBER):
    """Levenberg-Marquardt from the map's state in the map's floating type.
    Returns dict(R, t, X, cost, cg_steps, accepted)."""
    pb = Problem(m, huber)
    R, t, X = m["R"], m["t"], m["X"]
    dt_ = R.dtype
    lam = torch.tensor(1e-4, dtype=dt_, device=R.device)
    dc_prev = torch.zeros(pb.C, 6, dtype=dt_, device=R.device)
    cost = pb.cost(R, t, X)
    steps = accepted = 0
    for _ in range(iters):
        U, V, W, g_c, g_p = pb.blocks(R, t, X)
        if pb.C > pcg_min_c:
            dc, dp, n = _solve_pcg(pb, U, V, W, g_c, g_p, lam, dc_prev, cg_iters)
            steps += n
        else:
            dc, dp = _solve_dense(pb, U, V, W, g_c, g_p, lam)
        dR, dt = se3_exp(dc)
        R_new = nearest_rotation(dR @ R)
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = X + dp
        cost_new = pb.cost(R_new, t_new, X_new)
        finite = bool(torch.isfinite(dc).all() & torch.isfinite(dp).all()
                      & torch.isfinite(cost_new))
        if finite and bool(cost_new < cost):
            R, t, X, cost = R_new, t_new, X_new, cost_new
            lam = torch.clamp(lam * 0.3, min=1e-10)
            accepted += 1
        else:
            lam = torch.clamp(lam * 5.0, max=1e8)
        dc_prev = dc if finite else torch.zeros_like(dc)
    return dict(R=R, t=t, X=X, cost=cost, cg_steps=steps, accepted=accepted)


def centres(R, t):
    """[C,3] camera centres -R^T t."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]
