"""Where the dense sharded GBA and ``ba_solve`` part on the card, and why.

    python3 tools/dense_centre_gap.py [--device cpu]

On ``scripts/dist_worker.py``'s problem shape (``problems.arc_problem_arrays``,
C=64, P=4096, K=4, the dense branch) it solves with ``ba_solve`` and with
``dist_ba_solve`` at world size 1 (NCCL on a card, gloo on the CPU), each
also with one part swapped for the other solver's:

* ``dist``: the sharded solve as it is (the reference's gather
  back-substitution, ``ba._back_substitute``);
* ``dist_wtv``: the sharded solve back-substituting with the ``wtv`` kernel
  (``schur_ops``), the form it first had;
* ``ba_solve_zeroed``: ``ba_solve`` with the sharded solve's inactive-camera
  form (rows and columns zeroed, ``dist_ba._dense_step``) in place of its
  own (unit diagonal only).

Prints one JSON line per variant and iteration count (cost, the largest
camera-centre gap to ``ba_solve``'s at the same count), then one with the
largest |W| over the observations of the fixed cameras (the couplings the
two inactive forms treat differently) and the largest gap between the two
back-substitutions' landmark steps on the first LM step, each line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ccm_slam_tpu_torch import convert, problems  # noqa: E402
from ccm_slam_tpu_torch.ops import ba_kernels  # noqa: E402
from ccm_slam_tpu_torch.parallel import dist_ba  # noqa: E402
from ccm_slam_tpu_torch.solvers import ba  # noqa: E402

HUBER = 2.447651936


def wtv_back_substitute(prob, Vinv, W, g_p, delta_c, ci):
    """The landmark step through the ``wtv`` kernel."""
    wtv = ba_kernels.schur_ops(W, Vinv, ba_kernels.cam_csr(prob.cam_idx, delta_c.shape[0]))[2]
    delta_p = torch.einsum("pij,pj->pi", Vinv, g_p - wtv(delta_c.contiguous()))
    return torch.where(prob.point_valid[:, None], delta_p, 0.0)


def zeroed_solve_schur(prob, U, V, W, g_c, g_p, ci, lam):
    """``ba._solve_schur`` with ``dist_ba._dense_step``'s inactive form."""
    Vinv = ba.inv3x3(ba._damp(V, lam))
    S, b = ba._schur_system(ba._damp(U, lam), Vinv, W, g_c, g_p, ci)
    delta_c = dist_ba._dense_step(S, b.reshape(-1), prob.cam_fixed)
    return delta_c, ba._back_substitute(prob, Vinv, W, g_p, delta_c, ci)


def centres(R, t):
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def swapped(module, name, fn, solve):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        return solve()
    finally:
        setattr(module, name, real)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    prob = convert.ba_problem_from_numpy(problems.arc_problem_arrays(C=64, P=4096, K=4), dev)
    mesh = dist_ba.make_mesh(dev)
    local = dist_ba.shard_problem(prob, mesh)

    def dist_solve(iters):
        R, t, _, cost = dist_ba.dist_ba_solve(local, mesh, iters=iters)
        return R, t, cost

    def single(iters):
        R, t, _, cost, _ = ba.ba_solve(prob, iters=iters)
        return R, t, cost

    variants = {
        "ba_solve": single,
        "dist": dist_solve,
        "dist_wtv": lambda n: swapped(ba, "_back_substitute", wtv_back_substitute,
                                      lambda: dist_solve(n)),
        "ba_solve_zeroed": lambda n: swapped(ba, "_solve_schur", zeroed_solve_schur,
                                             lambda: single(n)),
    }
    for iters in (12, 40):
        R0, t0, _ = single(iters)
        for name, solve in variants.items():
            R, t, cost = solve(iters)
            gap = float((centres(R, t) - centres(R0, t0)).norm(dim=-1).max())
            print(json.dumps(dict(variant=name, iters=iters, cost=float(cost),
                                  centre_gap_to_ba_solve=gap, card=card)), flush=True)

    csr = ba_kernels.cam_csr(prob.cam_idx, prob.R.shape[0])
    U, V, W, g_c, g_p, _ = ba._build_normal_blocks(prob, prob.R, prob.t, prob.X, HUBER, csr)
    on_fixed = prob.cam_fixed[csr.ci.long()] & prob.obs_valid
    lam = torch.tensor(1e-4, device=dev)
    Vinv = ba.inv3x3(ba._damp(V, lam))
    S, b = ba._schur_system(ba._damp(U, lam), Vinv, W, g_c, g_p, csr.ci)
    delta_c = dist_ba._dense_step(S, b.reshape(-1), prob.cam_fixed)
    gather = ba._back_substitute(prob, Vinv, W, g_p, delta_c, csr.ci)
    kernel = wtv_back_substitute(prob, Vinv, W, g_p, delta_c, csr.ci)
    print(json.dumps(dict(
        fixed_camera_obs=int(on_fixed.sum()),
        max_abs_W_on_fixed_cameras=float(W[on_fixed].abs().max()) if on_fixed.any() else 0.0,
        first_step_max_abs_delta_p=float(gather.abs().max()),
        first_step_back_substitution_gap=float((gather - kernel).abs().max()),
        card=card)), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
