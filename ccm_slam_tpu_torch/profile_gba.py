"""Per-component timing of one stress-scale GBA LM iteration.

Counterpart of ``scripts/profile_gba.py``:

    python -m ccm_slam_tpu_torch.profile_gba [--reps 20] [--device cuda:0]

builds ``problems.stress_problem_arrays()`` (C=1024 cameras, P=131,072
landmarks, K=8 slots: E=1,048,576 observations) on the device and times each
component of the solver's iteration, printing one JSON line per component:

  build_normal_blocks  the fused normal-equation pass (``normal_blocks``)
  cost_eval            the Huber cost (``reproj_cost``)
  schur_matvec         the staged CG matvec: ``cam_broadcast`` -> per-
                       observation W products -> ``cam_reduce``
  cam_broadcast_f6     one ``cam_broadcast`` of a [C,6] vector
  cam_reduce_f6        one ``cam_reduce`` of an [E,6] array
  fused_schur_matvec   ``make_schur_matvec``'s off
  lm_iter_full         ``ba_solve(iters=1)`` (PCG branch)

On the card a component's time is its device time per call from
``torch.profiler`` (the summed time of the device kernels the calls ran, host
dispatch left out), with the CUDA-event time per call over back-to-back calls
beside it; on the CPU it is wall time per call.  Each component is called
``warmup + 2 * reps`` times on the card (``warmup + reps`` on the CPU); the
result carries that count so a caller can hold the launch counters to it.
The reference's ``lax.scan`` amortisation is not needed: PyTorch dispatches
each call on its own.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import convert, problems
from .ops import ba_kernels
from .solvers import ba

HUBER = 2.447651936


def _device_ms(fn, reps):
    """Device ms per call of ``fn`` over ``reps`` calls (torch.profiler), or
    None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / reps if busy_us > 0 else None


def _event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time(fn, reps, warmup, on_card):
    """(ms, how, event_ms or None, calls)."""
    for _ in range(warmup):
        fn()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps, "cpu wall", None, warmup + reps
    torch.cuda.synchronize()
    dev = _device_ms(fn, reps)
    ev = _event_ms(fn, reps)
    if dev is None:
        return ev, "cuda events", ev, warmup + 2 * reps
    return dev, "device (torch.profiler)", ev, warmup + 2 * reps


def components(prob: ba.BAProblem):
    """{name: zero-argument callable} of the profiled components on ``prob``."""
    C = prob.R.shape[0]
    P, K = prob.cam_idx.shape
    E = P * K
    dev = prob.R.device
    csr = ba_kernels.cam_csr(prob.cam_idx, C)
    broadcast, reduce = ba.pcg_transitions(prob.cam_idx, C)
    _, V, W, g_c, _, _ = ba._build_normal_blocks(prob, prob.R, prob.t, prob.X, HUBER, csr)
    Vinv = ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=dev))).contiguous()
    v = g_c.contiguous()
    y6 = torch.zeros(E, 6, dtype=torch.float32, device=dev)
    off = ba_kernels.make_schur_matvec(W, Vinv, prob.cam_idx, C)

    def cg_like_step():
        vk = broadcast(v).reshape(P, K, 6)
        y1 = torch.einsum("pkij,pki->pkj", W, vk)
        y3 = torch.einsum("pkij,pj->pki", W, torch.sum(y1, dim=1))
        return reduce(y3.reshape(E, 6))

    return {
        "build_normal_blocks": lambda: ba._build_normal_blocks(prob, prob.R, prob.t, prob.X,
                                                               HUBER, csr),
        "cost_eval": lambda: ba._cost(prob, prob.R, prob.t, prob.X, HUBER),
        "schur_matvec": cg_like_step,
        "cam_broadcast_f6": lambda: broadcast(v),
        "cam_reduce_f6": lambda: reduce(y6),
        "fused_schur_matvec": lambda: off(v),
        "lm_iter_full": lambda: ba.ba_solve(prob, iters=1),
    }


def profile_gba(prob: ba.BAProblem, reps: int = 20, warmup: int = 3) -> dict:
    """{component: {"ms", "how", "event_ms", "calls"}} on ``prob``'s device."""
    on_card = prob.R.device.type == "cuda"
    out = {}
    for name, fn in components(prob).items():
        n = max(1, reps // 5) if name == "lm_iter_full" else reps
        ms, how, ev, calls = _time(fn, n, warmup, on_card)
        out[name] = {"ms": ms, "how": how, "event_ms": ev, "calls": calls}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda:0 unless given (cpu on request)")
    args = ap.parse_args()
    prob = convert.ba_problem_from_numpy(problems.stress_problem_arrays(), args.device)
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    for name, res in profile_gba(prob, args.reps).items():
        print(json.dumps({"component": name, "ms": res["ms"], "how": res["how"],
                          "event_ms": res["event_ms"], "calls": res["calls"],
                          "C": C, "P": P, "K": K}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
