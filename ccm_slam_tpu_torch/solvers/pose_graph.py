"""Sim(3) pose-graph (essential graph) optimization (PyTorch).

Counterpart of ``ccm_slam_tpu/solvers/pose_graph.py``
(``Optimizer::OptimizeEssentialGraphLoopClosure``, cslam/src/Optimizer.cpp:
1058-1331): vertices are keyframe poses as Sim(3) world->cam, edges relative
Sim3 constraints with the error of g2o's EdgeSim3,
e_ij = log(S_ij * S_jw * S_iw^-1).  LM over all vertices; the step is a
dense LU solve of the [7V, 7V] normal matrix up to ``DENSE_MAX_VERTS``
vertices, matrix-free block-Jacobi PCG above (``solver="auto"``).

Edge Jacobians are forward-mode AD through the Sim3 chain (``torch.func.jvp``;
the 14 tangent directions, 7 per endpoint, batched along the edge axis)
where the reference takes ``jax.jacobian``.  Where an edge's error rotation
is exactly symmetric (a root or empty-slot edge of the spanning tree), the
derivative of ``so3_log`` is NaN in both packages, and NaN * 0 reaches the
normal equations even through an invalid edge: no step is then accepted,
as in the reference (ROADMAP section 3).

Sums over edges (the normal matrix, the gradient, the PCG product) are
segment sums in a fixed order: the edges' contributions are sorted by their
vertex (or vertex pair) once per problem, placed in a padded
[keys, width, ...] table at unique slots and summed along the width axis.
No float atomics; a rerun gives the same bits, and LM's accept gate compares
costs that do not depend on scheduling.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..utils.lie import Sim3, orthonormalize

# vertex count above which the dense [7V,7V] assembly + LU solve gives way to
# the matrix-free block-Jacobi PCG (O(V^3) against O(E) per CG step)
DENSE_MAX_VERTS = 384


@dataclass(frozen=True)
class PoseGraphProblem:
    S_w: Sim3                 # batched [V]: world->cam Sim3 per keyframe
    fixed: torch.Tensor       # [V] bool (e.g. the loop keyframe)
    vert_valid: torch.Tensor  # [V] bool
    i_idx: torch.Tensor       # [E] int (edge from j to i)
    j_idx: torch.Tensor       # [E] int
    S_meas: Sim3              # batched [E]: measured S_ij
    edge_valid: torch.Tensor  # [E] bool
    weight: torch.Tensor      # [E] float

    def replace(self, **kw) -> "PoseGraphProblem":
        return dataclasses.replace(self, **kw)


def _edge_error(xi_i, xi_j, S_iw: Sim3, S_jw: Sim3, S_ij: Sim3):
    """log(S_ij * exp(xi_j) S_jw * (exp(xi_i) S_iw)^-1) -> [E,7]."""
    Si = Sim3.exp(xi_i).compose(S_iw)
    Sj = Sim3.exp(xi_j).compose(S_jw)
    return S_ij.compose(Sj).compose(Si.inverse()).log()


def relative_sim3(S_iw: Sim3, S_jw: Sim3) -> Sim3:
    """Measured S_ij such that the edge error at the current estimate is 0."""
    return S_iw.compose(S_jw.inverse())


class Segments:
    """A fixed-order segment sum over ``keys`` [n] in [0, n_keys): rows are
    sorted by key once (stably: within a key, in row order), placed at
    unique slots of a zero [n_keys, width, ...] table and summed along the
    width axis.  Building the layout reads the widest segment on the host."""

    def __init__(self, keys: torch.Tensor, n_keys: int):
        keys = keys.long()
        self.n_keys = n_keys
        self.order = torch.argsort(keys, stable=True)
        self.key = keys[self.order]
        counts = torch.bincount(keys, minlength=n_keys)
        starts = torch.cumsum(counts, 0) - counts
        self.slot = torch.arange(keys.shape[0], device=keys.device) - starts[self.key]
        self.width = max(int(counts.max()), 1) if keys.numel() else 1

    def sum(self, rows: torch.Tensor) -> torch.Tensor:
        table = rows.new_zeros((self.n_keys, self.width) + tuple(rows.shape[1:]))
        table = table.index_put((self.key, self.slot), rows[self.order])
        return table.sum(1)


def _edge_system(prob: PoseGraphProblem, S_cur: Sim3, ii, jj):
    """Per-edge errors [E,7] and Jacobians Ji, Jj [E,7,7] at the current
    vertices: one forward-mode pass over 14 copies of the edge batch, copy
    d carrying the tangent e_d of xi_i (d < 7) or e_{d-7} of xi_j."""
    E = ii.shape[0]
    dev = S_cur.t.device
    S_iw, S_jw = S_cur[ii.repeat(14)], S_cur[jj.repeat(14)]
    S_ij = prob.S_meas[torch.arange(E, device=dev).repeat(14)]
    basis = torch.eye(7, dtype=torch.float32, device=dev).repeat_interleave(E, 0)  # [7E,7]
    zeros = torch.zeros_like(basis)
    err, d = torch.func.jvp(lambda xi, xj: _edge_error(xi, xj, S_iw, S_jw, S_ij),
                            (torch.cat([zeros, zeros]), torch.cat([zeros, zeros])),
                            (torch.cat([basis, zeros]), torch.cat([zeros, basis])))
    d = d.reshape(14, E, 7)
    return err[:E], d[:7].permute(1, 2, 0), d[7:].permute(1, 2, 0)


def _cost(prob: PoseGraphProblem, S_cur: Sim3, ii, jj):
    err = _edge_error(torch.zeros(ii.shape[0], 7, device=S_cur.t.device),
                      torch.zeros(ii.shape[0], 7, device=S_cur.t.device),
                      S_cur[ii], S_cur[jj], prob.S_meas)
    return torch.sum(torch.sum(err * err, -1) * prob.edge_valid * prob.weight)


class _DenseLayout:
    """Where the per-edge 7x7 blocks land in the [V,V,7,7] normal matrix:
    diagonal blocks (a == b) summed per vertex, off-diagonal blocks per
    vertex pair, each with a fixed-order segment sum."""

    def __init__(self, ii, jj, V: int):
        a = torch.cat([ii, jj, ii, jj])  # blocks (ii,ii), (jj,jj), (ii,jj), (jj,ii)
        b = torch.cat([ii, jj, jj, ii])
        on_diag = a == b
        self.diag_rows = torch.nonzero(on_diag).flatten()
        self.off_rows = torch.nonzero(~on_diag).flatten()
        self.diag = Segments(a[self.diag_rows], V)
        pair = a[self.off_rows] * V + b[self.off_rows]
        uniq, inv = torch.unique(pair, return_inverse=True)
        self.off = Segments(inv, uniq.shape[0])
        self.pa, self.pb = uniq // V, uniq % V
        self.V = V

    def assemble(self, blocks):
        V = self.V
        H = blocks.new_zeros(V, V, 7, 7)
        ar = torch.arange(V, device=blocks.device)
        H = H.index_put((ar, ar), self.diag.sum(blocks[self.diag_rows]))
        H = H.index_put((self.pa, self.pb), self.off.sum(blocks[self.off_rows]))
        return H.permute(0, 2, 1, 3).reshape(V * 7, V * 7)


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20, solver: str = "auto",
                        cg_iters: int = 48):
    """Run ``iters`` LM iterations; returns (S_w_opt: Sim3 [V], final_cost).

    ``solver``: "dense" (LU on the assembled [7V,7V] normal matrix), "pcg"
    (matrix-free conjugate gradients over the edge list, ``cg_iters`` steps,
    block-diagonal 7x7 Jacobi preconditioner), or "auto" (by vertex count)."""
    V = prob.fixed.shape[0]
    if solver == "auto":
        solver = "dense" if V <= DENSE_MAX_VERTS else "pcg"
    dev = prob.S_w.t.device
    ii, jj = prob.i_idx.long(), prob.j_idx.long()
    vseg = Segments(torch.cat([ii, jj]), V)  # per-vertex sums over both endpoints
    dense = _DenseLayout(ii, jj, V) if solver == "dense" else None
    frozen_v = prob.fixed | ~prob.vert_valid
    free = ~frozen_v
    frozen = torch.repeat_interleave(frozen_v, 7)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def dense_solve(Jis, Jjs, w, b, lam):
        Jis_w = Jis * w[:, None, None]
        Jjs_w = Jjs * w[:, None, None]
        blocks = torch.cat([Jis_w.transpose(1, 2) @ Jis, Jjs_w.transpose(1, 2) @ Jjs,
                            Jis_w.transpose(1, 2) @ Jjs, Jjs_w.transpose(1, 2) @ Jis])
        H = dense.assemble(blocks)
        bf = b.reshape(-1)
        # freeze fixed/invalid vertices: identity rows
        H = torch.where(frozen[:, None] | frozen[None, :], 0.0, H)
        H = H + torch.diag(frozen.to(H.dtype))
        bf = torch.where(frozen, 0.0, bf)
        H = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-8))
        return torch.linalg.solve_ex(H, bf[:, None])[0].reshape(V, 7)

    def pcg_solve(Jis, Jjs, w, b, lam):
        Jis_w = Jis * w[:, None, None]
        Jjs_w = Jjs * w[:, None, None]
        JisT_w, JjsT_w = Jis_w.transpose(1, 2), Jjs_w.transpose(1, 2)
        # block diagonal of H for the damping and the Jacobi preconditioner
        Hd = vseg.sum(torch.cat([JisT_w @ Jis, JjsT_w @ Jjs]))
        dclip = torch.clamp(torch.diagonal(Hd, dim1=1, dim2=2), min=1e-8)
        lam_d = lam * dclip
        Hd_damped = torch.where(free[:, None, None], Hd + torch.diag_embed(lam_d), eye7)
        Minv = torch.linalg.inv_ex(Hd_damped + 1e-8 * eye7)[0]

        def Hx(x):
            x = torch.where(free[:, None], x, 0.0)
            y = (Jis @ x[ii][..., None] + Jjs @ x[jj][..., None])  # [E,7,1] error space
            out = vseg.sum(torch.cat([JisT_w @ y, JjsT_w @ y])[..., 0])
            return torch.where(free[:, None], out + lam_d * x, 0.0)

        b0 = torch.where(free[:, None], b, 0.0)
        x = torch.zeros_like(b0)
        r = b0
        z = (Minv @ r[..., None])[..., 0]
        p = z
        rz = torch.sum(r * z)
        for _ in range(cg_iters):
            Ap = Hx(p)
            denom = torch.sum(p * Ap)
            alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = (Minv @ r[..., None])[..., 0]
            rz_new = torch.sum(r * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            rz = rz_new
        return x

    S_cur = prob.S_w
    lam = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    w = (prob.edge_valid * prob.weight).to(torch.float32)
    for _ in range(iters):
        errs, Jis, Jjs = _edge_system(prob, S_cur, ii, jj)
        cost = torch.sum(w * torch.sum(errs * errs, -1))
        b = -vseg.sum(torch.cat([(Jis * w[:, None, None]).transpose(1, 2) @ errs[..., None],
                                 (Jjs * w[:, None, None]).transpose(1, 2) @ errs[..., None]])
                      [..., 0])
        solve = dense_solve if solver == "dense" else pcg_solve
        dx = torch.where(frozen_v[:, None], 0.0, solve(Jis, Jjs, w, b, lam))
        S = Sim3.exp(dx).compose(S_cur)
        # iterated composes drift off SO(3) in float32: project back
        S_new = Sim3(s=S.s, R=orthonormalize(S.R), t=S.t)
        accept = (_cost(prob, S_new, ii, jj) < cost) & torch.all(torch.isfinite(dx))
        S_cur = Sim3(s=torch.where(accept, S_new.s, S_cur.s),
                     R=torch.where(accept, S_new.R, S_cur.R),
                     t=torch.where(accept, S_new.t, S_cur.t))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
    return S_cur, _cost(prob, S_cur, ii, jj)
