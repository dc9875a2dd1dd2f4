"""Plain pose-only bundle adjustment: the semantics of the program's
``solvers.pose_opt.optimize_pose``, the per-frame tracking optimizer.

One camera pose against a frame's landmark associations: ``rounds`` rounds
of ``iters`` Levenberg-Marquardt iterations (multiplicative damping of the
diagonal plus 1e-9, lambda from 1e-3 in every round, x0.5 on an accepted
step and x4 on a rejected one, an exact-cost accept gate), the Huber kernel
(delta on the residual scale) in every round but the last, and after each
round the associations re-classified: an inlier has chi2 = r^T r / sigma2
at most 5.991 and positive depth.  Left-multiplicative SE(3) updates with
the analytic projection Jacobian; rotations projected onto SO(3) by SVD
after each round.  Runs in float64 on the host.

The re-classification is a hard gate, so an association that a round
leaves within ``TIE`` of it may fall on either side in a float32 program,
and the rounds after it then optimize over another set: ``solve_all``
follows both sides of every such tie.
"""

from __future__ import annotations

import itertools

import torch

from .ba_ref import HUBER, nearest_rotation, se3_exp

CHI2_MONO = 5.991
# Half-width, in chi2, of the gate's tie band: float32 and float64 runs of
# the program's optimizer on the client cell's own tracking steps part by up
# to 0.031 in an association's chi2 at a round's end (745 rounds).
TIE = 0.06
MAX_PATHS = 16


def _residuals(R, t, X, uv, intr):
    fx, fy, cx, cy = intr
    Xc = X @ R.T + t
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    r = torch.stack([fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy], -1) - uv
    return r, Xc, zs


def _rho(chi2, huber):
    d2 = huber * huber
    return torch.where(chi2 <= d2, chi2, 2.0 * huber * torch.sqrt(torch.clamp(chi2, min=0.0)) - d2)


def _cost(R, t, X, uv, w, intr, use_huber):
    r, _, _ = _residuals(R, t, X, uv, intr)
    chi2 = w * torch.sum(r * r, -1)
    return torch.sum(_rho(chi2, HUBER) if use_huber else chi2)


def _round(R, t, X, uv, w_conf, intr, use_huber, iters):
    """One round of LM over the weights ``w_conf``; R projected onto SO(3)."""
    fx, fy = intr[0], intr[1]
    lam = 1e-3
    for _ in range(iters):
        r, Xc, zs = _residuals(R, t, X, uv, intr)
        chi2 = w_conf * torch.sum(r * r, -1)
        w = w_conf * (torch.where(chi2 <= HUBER ** 2, 1.0,
                                  HUBER / torch.sqrt(torch.clamp(chi2, min=1e-12)))
                      if use_huber else 1.0)
        iz = 1.0 / zs
        x, y = Xc[:, 0], Xc[:, 1]
        Jp = torch.zeros(X.shape[0], 2, 3, dtype=X.dtype)
        Jp[:, 0, 0], Jp[:, 0, 2] = fx * iz, -fx * x * iz * iz
        Jp[:, 1, 1], Jp[:, 1, 2] = fy * iz, -fy * y * iz * iz
        hat = torch.zeros(X.shape[0], 3, 3, dtype=X.dtype)
        hat[:, 0, 1], hat[:, 0, 2], hat[:, 1, 2] = -Xc[:, 2], Xc[:, 1], -Xc[:, 0]
        hat = hat - hat.transpose(1, 2)
        J = torch.cat([Jp, -Jp @ hat], -1)  # d r / d (rho, phi) of a left update
        H = torch.einsum("n,nij,nik->jk", w, J, J)
        b = -torch.einsum("n,nij,ni->j", w, J, r)
        cost = torch.sum(_rho(chi2, HUBER) if use_huber else chi2)
        dx = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H))
                                + 1e-9 * torch.eye(6, dtype=X.dtype), b)
        dR, dt = se3_exp(dx)
        R1, t1 = dR @ R, dR @ t + dt
        if bool(torch.isfinite(dx).all()) and float(
                _cost(R1, t1, X, uv, w_conf, intr, use_huber)) < float(cost):
            R, t, lam = R1, t1, max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e6)
    return nearest_rotation(R), t


def solve_all(R0, t0, X, uv, valid, sigma2, intr, rounds=4, iters=10):
    """Every result the optimizer may reach in float32, the nominal one
    first: [(R, t, active, cost)], the pose, the associations that the last
    round optimized over and its plain least-squares cost there.  Each
    re-classification that leaves associations within ``TIE`` of the gate
    opens a path for every other side they may fall on (fewer flips first;
    paths that reach one set of associations are one; ``MAX_PATHS`` paths
    in all)."""
    X, uv, sigma2 = X.double(), uv.double(), sigma2.double()
    intr = [float(v) for v in intr]
    w0 = torch.where(valid, 1.0 / sigma2, torch.zeros_like(sigma2))
    paths = [(nearest_rotation(R0.double()), t0.double(), valid.clone())]
    for k in range(rounds):
        last = k == rounds - 1
        nxt, spare = [], MAX_PATHS - len(paths)
        for R, t, active in paths:
            R, t = _round(R, t, X, uv, w0 * active, intr, not last, iters)
            if last:
                nxt.append((R, t, active))
                continue
            r, _, z = _residuals(R, t, X, uv, intr)
            chi2 = w0 * torch.sum(r * r, -1)
            inlier = valid & (chi2 <= CHI2_MONO) & (z > 0)
            ties = torch.nonzero(valid & (z > 0) & (torch.abs(chi2 - CHI2_MONO) <= TIE)).flatten()
            sides = (list(flip) for n in range(len(ties) + 1)
                     for flip in itertools.combinations(ties.tolist(), n))
            for flip in sides:
                other = inlier.clone()
                other[flip] = ~other[flip]
                if any(torch.equal(other, a) for _, _, a in nxt):
                    continue  # a path that rejoins another optimizes the same set
                if flip and spare == 0:
                    break
                if flip:
                    spare -= 1
                nxt.append((R, t, other))
        paths = nxt
    return [(R, t, active, float(_cost(R, t, X, uv, w0 * active, intr, False)))
            for R, t, active in paths]


def solve(R0, t0, X, uv, valid, sigma2, intr, rounds=4, iters=10):
    """(R, t, active, cost) of the nominal path: every association on the
    side of the gate that float64 puts it."""
    return solve_all(R0, t0, X, uv, valid, sigma2, intr, rounds, iters)[0]


def cost_at(R, t, X, uv, sigma2, active, intr):
    """The last round's plain least-squares cost over ``active`` at (R, t)."""
    w = torch.where(active, 1.0 / sigma2.double(), torch.zeros_like(sigma2.double()))
    return float(_cost(R.double(), t.double(), X.double(), uv.double(), w,
                       [float(v) for v in intr], False))
