"""Landmark-sharded global bundle adjustment over ``torch.distributed``.

Counterpart of ``ccm_slam_tpu/parallel/dist_ba.py`` (the reference's
multithreaded g2o GBA, ``Optimizer::MapFusionGBA``,
cslam/src/Optimizer.cpp:646-859): one process per rank, each running the
same LM iteration on its contiguous block of landmark rows, the camera
arrays whole on every rank.  The ranks share sums of camera-side partials.
Each sum is an all-gather whose parts are added in rank order, so every rank
holds the same bits:

* dense (C <= ``solvers.ba.pcg_min_c()``): each rank damps its partial U and
  builds its partial [6C,6C] reduced system and right-hand side (so the sum
  carries n_ranks * 1e-8 on U's diagonal, as the reference's does); one sum
  per LM step; the Cholesky solve runs replicated; each rank back-substitutes
  its landmarks in the reference's gather form (``ba._back_substitute``, as
  the unsharded dense solve does);
* matrix-free PCG: U and g_c summed once per LM step; every CG step applies
  S v as this rank's ``schur_ops`` off (over its own camera CSR) plus one sum
  of a [C,6] vector, and b's correction is summed the same way
  (``ba._solve_schur_pcg`` with ``sum_cams``); landmark back-substitution
  stays local.

Trial costs, and on the PCG branch the flag of a non-finite landmark step,
are summed the same way, so the accept decision and the CG loop's host-side
stop test agree on every rank and the collectives stay in step.

The reference's quirks are kept: the dense branch zeroes inactive cameras'
rows and columns and then adds ``diag(inactive) + 1e-8 I``, leaves
``delta_p`` out of its finiteness test and passes the CG warm start through
unchanged.  ``state`` carries (lam, warm start, cost) across chunks, so a
chunked solve follows the monolithic one (INTERRUPTBA).

Backends: NCCL for a CUDA device (at world size 1 too), gloo for the CPU;
any other pairing raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import ba_kernels
from ..solvers import ba
from ..utils.lie import orthonormalize, se3_exp

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# landmark-major fields of BAProblem: sharded by rows; the rest stay whole
LANDMARK_FIELDS = ("X", "cam_idx", "uv", "sigma2", "obs_valid", "point_valid")


@dataclass(frozen=True)
class Mesh:
    """This process's place in the landmark-sharded solve."""

    group: object          # torch.distributed process group
    rank: int
    world_size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


def _backend_for(device: torch.device) -> str:
    if device.type not in _BACKENDS:
        raise ValueError(f"no collective backend for device type {device.type!r}")
    return _BACKENDS[device.type]


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of ``group`` (default: the world group) on ``device`` (the
    card unless told otherwise; under torchrun ``cuda:LOCAL_RANK``).

    With no process group initialised, makes one: from torchrun's
    environment when it is set, else a world-size-1 group on a ``HashStore``.
    A later call reuses the group (``init_process_group`` runs once per
    process).  The group's backend must be NCCL for a CUDA device and gloo
    for the CPU."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = _backend_for(dev)
    if group is None:
        if not dist.is_initialized():
            if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
                dist.init_process_group(backend)
            else:
                dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        group = dist.group.WORLD
    got = str(dist.get_backend(group))
    if got != backend:
        raise ValueError(f"a mesh on {dev} needs a {backend} process group, not {got}")
    return Mesh(group=group, rank=dist.get_rank(group), world_size=dist.get_world_size(group),
                device=dev)


def _check_device(device: torch.device, mesh: Mesh) -> None:
    if device != mesh.device:
        raise ValueError(f"the problem is on {device}, the mesh on {mesh.device}")
    if mesh.backend != _backend_for(device):
        raise ValueError(f"a problem on {device} cannot use a {mesh.backend} process group")


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[world_size, *x.shape]: every rank's ``x``, in rank order."""
    x = x.contiguous()
    out = torch.empty(mesh.world_size * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=mesh.group)
    return out.view(mesh.world_size, *x.shape)


def sum_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order: the same bits on
    every rank, whatever order the backend would reduce in."""
    parts = _all_gather(x, mesh)
    out = parts[0]
    for r in range(1, mesh.world_size):
        out = out + parts[r]
    return out


def shard_rows(n_points: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of landmark rows."""
    if n_points % mesh.world_size:
        raise ValueError(f"{n_points} landmarks do not divide over {mesh.world_size} ranks")
    n = n_points // mesh.world_size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_problem(prob: ba.BAProblem, mesh: Mesh) -> ba.BAProblem:
    """This rank's landmark rows of ``prob`` (``LANDMARK_FIELDS``); camera
    arrays and intrinsics whole.  The world size must divide P."""
    _check_device(prob.R.device, mesh)
    rows = shard_rows(prob.X.shape[0], mesh)
    return prob.replace(**{f: getattr(prob, f)[rows].contiguous() for f in LANDMARK_FIELDS})


def gather_points(X_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's landmark rows, in rank order: the whole [P,3]."""
    return _all_gather(X_local, mesh).reshape(-1, 3)


def solver_state(C: int, device):
    """Fresh LM carry of a chunked solve: (lam, CG warm start [C,6], cost);
    cost +inf means "unknown: compute on entry"."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(1e-4, **f32), torch.zeros(C, 6, **f32),
            torch.tensor(float("inf"), **f32))


def _local_schur_terms(prob_local: ba.BAProblem, R, t, X_local, lam, huber_delta, csr):
    """This shard's normal blocks and its partial dense Schur system (the
    small-C branch), U damped before the sum as in the reference.

    Returns (S_partial [6C,6C], b_partial [6C], Vinv [Pl,3,3], W [Pl,K,6,3],
    g_p [Pl,3], cost_partial)."""
    U, V, W, g_c, g_p, cost = ba._build_normal_blocks(prob_local, R, t, X_local,
                                                      huber_delta, csr)
    Vinv = ba.inv3x3(ba._damp(V, lam))
    S, b = ba._schur_system(ba._damp(U, lam), Vinv, W, g_c, g_p, csr.ci)
    return S, b.reshape(-1), Vinv, W, g_p, cost


def _dense_step(S, b, cam_fixed):
    """delta_c [C,6] of the summed dense system: inactive cameras' rows and
    columns zeroed, then ``+ diag(inactive) + 1e-8 I``; a failed
    factorization gives NaN (rejected by LM)."""
    C = cam_fixed.shape[0]
    inactive = torch.repeat_interleave(cam_fixed, 6) | (torch.diagonal(S) <= 1e-7)
    S = torch.where(inactive[:, None] | inactive[None, :], 0.0, S)
    S = S + torch.diag(inactive.to(S.dtype)) + 1e-8 * ba._eye(6 * C, S)
    b = torch.where(inactive, 0.0, b)
    L, info = torch.linalg.cholesky_ex(S)
    delta_c = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(C, 6)
    delta_c = torch.where(info == 0, delta_c, float("nan"))
    return torch.where(cam_fixed[:, None], 0.0, delta_c)


def dist_ba_solve(prob_local: ba.BAProblem, mesh: Mesh, iters: int = 20,
                  huber_delta: float = 2.447651936, cg_iters: int = 16, state=None,
                  return_state: bool = False):
    """LM over this rank's shard (``shard_problem``); every rank of the mesh
    makes the same call.  Returns (R, t, X_local, cost), plus the carry
    ``(lam, dc, cost)`` with ``return_state=True``; R, t, cost and the carry
    are the same on every rank."""
    _check_device(prob_local.R.device, mesh)
    C = prob_local.R.shape[0]
    use_pcg = C > ba.pcg_min_c()
    if state is None:
        state = solver_state(C, prob_local.R.device)
    lam, dc_prev, cost_in = state
    csr = ba_kernels.cam_csr(prob_local.cam_idx, C)
    fixed = prob_local.cam_fixed

    def total(x):
        return sum_ranks(x, mesh)

    def local_cost(R, t, X):
        return ba._cost(prob_local, R, t, X, huber_delta)

    R, t, X = prob_local.R, prob_local.t, prob_local.X
    # every rank evaluates the entry cost (a collective); it counts only when
    # the carried cost is unknown
    cost = torch.where(torch.isfinite(cost_in), cost_in, total(local_cost(R, t, X)))
    for _ in range(iters):
        if use_pcg:
            U_p, V, W, g_c_p, g_p, _ = ba._build_normal_blocks(prob_local, R, t, X,
                                                               huber_delta, csr)
            Ug = total(torch.cat([U_p.reshape(C, 36), g_c_p], dim=1))
            delta_c, delta_p = ba._solve_schur_pcg(
                prob_local, Ug[:, :36].reshape(C, 6, 6), V, W, Ug[:, 36:], g_p, csr, lam,
                dc_prev, cg_iters=cg_iters, sum_cams=total)
        else:
            S_p, b_p, Vinv, W, g_p, _ = _local_schur_terms(prob_local, R, t, X, lam,
                                                           huber_delta, csr)
            n = 6 * C
            Sb = total(torch.cat([S_p.reshape(-1), b_p]))
            delta_c = _dense_step(Sb[:n * n].reshape(n, n), Sb[n * n:], fixed)
            delta_p = ba._back_substitute(prob_local, Vinv, W, g_p, delta_c, csr.ci)

        dR, dt = se3_exp(delta_c)
        R_new = orthonormalize(dR @ R)  # keep the iterate on SO(3)
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = X + delta_p
        if use_pcg:
            # delta_p is this rank's: its finiteness is summed with the cost
            bad_p = (~torch.isfinite(delta_p).all()).to(torch.float32)
            cost_bad = total(torch.stack([local_cost(R_new, t_new, X_new), bad_p]))
            cost_new = cost_bad[0]
            finite = (torch.isfinite(delta_c).all() & (cost_bad[1] == 0)
                      & torch.isfinite(cost_new))
        else:
            cost_new = total(local_cost(R_new, t_new, X_new))
            finite = torch.isfinite(cost_new) & torch.isfinite(delta_c).all()
        accept = (cost_new < cost) & finite
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-10),
                          torch.clamp(lam * 5.0, max=1e8))
        if use_pcg:
            dc_prev = torch.where(finite, delta_c, 0.0)
    if return_state:
        return R, t, X, cost, (lam, dc_prev, cost)
    return R, t, X, cost
