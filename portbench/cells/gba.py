"""Server global BA: whole solves of one map, back to back.

The map comes from ``gen.gba_maps`` (the traffic's ``map``), its slots in
an order drawn from the seed; each step is one ``ba_solve`` of it from the
same perturbed start, as the server's GBA calls it (``gba_iterations`` LM
iterations, ``cg_iters`` CG steps at most, the PCG branch beyond
``pcg_min_c`` keyframes).  Set-up makes the map and runs one solve, which
builds the kernels and warms every shape.

The check takes solves of the window drawn from the seed and compares
each with ``reference.ba_ref.solve`` from the same start in float64:

* ``cost_gap``: the float64 cost of the program's final state against
  the reference's final cost, relative;
* ``cost_self_gap``: the cost the program reports against the float64
  cost of the state it returns, relative;
* ``centre_gap_m``: the largest distance between a keyframe centre of the
  program and of the reference.
"""

from __future__ import annotations

import random

import torch

from ccm_slam_tpu_torch.ops import ba_kernels
from ccm_slam_tpu_torch.solvers import ba

from ..gen import gba_maps
from ..reference import ba_ref


def _problem(m):
    fx, fy, cx, cy = m["intr"].unbind()
    return ba.BAProblem(R=m["R"], t=m["t"], X=m["X"], cam_idx=m["cam_idx"], uv=m["uv"],
                        sigma2=m["sigma2"], obs_valid=m["obs_valid"], cam_fixed=m["cam_fixed"],
                        point_valid=m["point_valid"], fx=fx, fy=fy, cx=cx, cy=cy)


def _worst(xs):
    """The largest reading; NaN (which fails its limit) when any is NaN or
    there is none."""
    return float("nan") if not xs or any(x != x for x in xs) else max(xs)


class Cell:
    def __init__(self, config, traffic, seed, dev, root):
        if ba.pcg_min_c() != config["pcg_min_c"]:
            raise RuntimeError(f"the program's PCG threshold is {ba.pcg_min_c()}, the "
                               f"configuration states {config['pcg_min_c']}")
        if traffic["map"]["slots"] != config["obs_slots"]:
            raise RuntimeError("the traffic's observation slots are not the configuration's")
        self.seed, self.limits = seed, traffic["checks"]
        self.iters, self.cg_iters = config["gba_iterations"], config["cg_iters"]
        self.map = gba_maps.make_map(traffic, seed, dev)
        self.prob = _problem(self.map)
        self.shape = (self.map["R"].shape[0], *self.map["cam_idx"].shape)
        self.outs = []
        self.solve = lambda: ba.ba_solve(self.prob, iters=self.iters, cg_iters=self.cg_iters)
        self.solve()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(self):
        self.outs.append(self.solve()[:4])
        return 1

    def end_to_end(self, name, window_s, n):
        if name == "gba_solve_ms":
            return window_s / n * 1e3
        raise KeyError(name)

    def reset_counters(self):
        ba_kernels.reset_launch_counts()
        self._n0 = len(self.outs)

    def counters(self):
        solves = len(self.outs) - self._n0
        launches = ba_kernels.launch_counts()
        return dict(solves=solves, iters=self.iters, launches=launches, shape=self.shape,
                    cg_steps=(launches["schur_off"] - self.iters * solves) / solves)

    def check(self):
        costs = torch.stack([o[3] for o in self.outs])
        failed = int(torch.sum(~torch.isfinite(costs)))
        rng = random.Random(self.seed)
        picks = sorted({0, rng.randrange(len(self.outs))})
        outs = [self.outs[i] for i in picks]
        self.outs, self.prob = [], None
        m64 = ba_ref.as_dtype(self.map, torch.float64)
        ref = ba_ref.solve(m64, self.iters, self.cg_iters)
        pb = ba_ref.Problem(m64)
        c_ref = float(ref["cost"])
        ctr_ref = ba_ref.centres(ref["R"], ref["t"])
        readings = []
        for R, t, X, cost in outs:
            R, t, X = R.double(), t.double(), X.double()
            c = float(pb.cost(R, t, X))
            ctr = ba_ref.centres(R, t)
            readings.append(dict(
                cost_gap=abs(c - c_ref) / c_ref, cost_self_gap=abs(float(cost) - c) / c,
                centre_gap_m=float(torch.max(torch.linalg.norm(ctr - ctr_ref, dim=-1)))))
        gaps = {k: _worst([r[k] for r in readings]) for k in readings[0]}
        return failed, {k: (v, self.limits[k]) for k, v in gaps.items()}

    def release(self):
        self.map = None


def control(cell):
    """The control, one precision below the configuration's float32: the
    reference in bfloat16 in the program's place.  (TF32 would reach no
    product of the solve: its 3x3 and 6x6 products run as matrix-vector
    kernels.)"""
    low = ba_ref.as_dtype(cell.map, torch.bfloat16)

    def solve():
        r = ba_ref.solve(low, cell.iters, cell.cg_iters)
        return r["R"], r["t"], r["X"], r["cost"]

    cell.solve = solve


# Faults planted under the timed path, for the calibration's readings:
# name -> (module, function, maker of the broken function).
FAULTS = {}
