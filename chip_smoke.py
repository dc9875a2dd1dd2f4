"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ccm_slam_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card, and drives the port's paths through their
entry points with the launch counts set to 0 before each path and held to
that path's own expected counts after it:

  1. device and build, and the tensor cores' 1-bit product: its fragment
     mapping checked and its rate measured (``tools/mma_b1_rate.py``);
  2. the BA kernels at the server-GBA shapes, on a ragged case, at the
     client's local-BA widths (K=16 and K=32 observation slots, and a ragged
     K=12 case) and at its initialization BA's (C=160, P=24,576, K=16, every
     empty slot on camera 0), each bit-identical on a rerun;
  3. server-scale global BA (PCG branch), local-BA-size BA (dense branch, at
     K=8, 16 and 32), an interrupted (chunked) solve, the pose-only step;
  4. kernel times, all taken before the first long profiler window: every
     BA kernel (``cam_reduce`` included) at the server-GBA shapes,
     ``normal_blocks``, ``cam_reduce`` and ``reproj_cost`` at the client's
     local-BA shape (C=40, P=4096, K=16), ``reproj_cost``, the Schur
     operators and ``normal_blocks`` at its initialization BA's,
     ``normal_blocks``, ``cam_reduce``, ``reproj_cost``,
     ``make_schur_matvec``, ``schur_ops``' rhs and wtv and ``cam_broadcast``
     (F=6 and F=12) at the stress shape (C=1024, P=131,072, K=8),
     ``cam_broadcast`` (F=12) also at the local-BA, initialization-BA and
     bench shapes, warm and with L2 flushed before each call, beside
     ``index_select``; ``hamming_top2`` at 1024 x 1024, 1024 x 16384,
     1024 x 24576, 1024 x 32768 (a BoW transform against vocab32k),
     81,920 x 32,768 (an ingest's BoW batch against vocab32k) and 8,192 x
     32,768 (a training block of the vocabulary trainer) against the
     1-bit MMA rate measured in phase 1; then the solve's wall
     and device time;
  5. ``hamming_top2`` against its plain version: 1024 x 16384 and 1024 x
     1024 with a quarter of the targets invalid, a ragged case, invalid
     queries, a single valid target, ties inside one 8-target MMA tile,
     across tiles and across the kernel's target slices, all targets equal,
     the vocabulary bootstrap's 163,840 x 1,024, a BoW transform's 1,024 x
     32,768, an ingest's BoW batch, (80 x 1,024) x 32,768, and a training
     block, 8,192 x 32,768 with every query and word valid -- equal
     outputs, and bit-identical on a second run;
  6. the client bootstrap at 752x480: rendered corridor frames (EuRoC
     intrinsics and radtan) -> ``orb.extract`` -> ``build_frame`` ->
     ``search_for_initialization`` -> ``initialize_two_view``, gated on the
     renderer's ground truth, and the same frames through the port on the
     CPU;
  7. relocalization through the ``Tracker``: bootstrapped on the same frames,
     its 16384-slot landmark arena filled, then a later frame relocalized
     (``match_brute`` -> the ``hamming_top2`` kernel, RANSAC-PnP, refine,
     local-map gate), checked against ground truth;
  8. front-end step times (medians of 5 runs with their spread);
  9. ``cam_reduce`` (F=6 and 42 at the server-GBA and stress shapes, and a
     ragged case whose ids -1 and >= C must be dropped),
     ``make_schur_matvec`` with ``schur_ops``' rhs and wtv (server-GBA and
     stress shapes), ``reproj_cost`` and ``cam_broadcast`` F=6 (stress
     shape) against their plain versions, bit-identical on a rerun;
 10. the GBA profiling path: ``profile_gba`` at the stress shape (C=1024,
     P=131,072, K=8), every component's device time;
 11. the single-agent client loop at full width: ``Tracker.process_image``
     over 200 rendered 752x480 corridor frames (rendered on the card first)
     with ``rendered_ci_config(1.0)``, gated on tracking, LOST and keyframe
     ATE against ground truth; per-frame wall times, device kernels and busy
     share of profiled frames, host reads;
 12. the single-agent loop at full width: ``StandaloneSystem.process_image``
     over the 340 rendered 752x480 frames of the loop circuit
     (``rendered_ci_config(1.0)``, 1,024 words): tracking, the vocabulary
     bootstrap, loop detection, ``estimate_sim3`` (``match_brute``: the
     ``hamming_top2`` kernel), the loop correction with its Sim(3) essential
     graph, GBA at 160 keyframe slots (the PCG branch's kernels) and
     redundant-keyframe culling, then ``run_gba(40)``; gated on tracking,
     LOST, a closure, a GBA, loop edges on both endpoints, map structure and
     keyframe ATE; walls per frame, per loop-closing stage, of the bootstrap
     and of each GBA (with its device time and CG steps), and the device
     kernels and busy share of the closing ``try_close`` replayed under the
     profiler;
 13. two agents merge on the server at full width: two ``Tracker``s over
     overlapping spans of the rendered corridor (2 x 120 frames at 752x480,
     rendered on the card), each publishing every 4th step through the
     wire codec (``pack_map_msg``/``unpack_map_msg``, both directions) into
     a ``Server`` with the port's vocab32k (``ingest``, ``mapping_step``
     per new keyframe: fusion, loop detection, cross-map matching and the
     merge; ``idle_step`` every step: interruptible GBA chunks, then the
     final GBA); gated on the merge (both agents in one slot), each agent's
     keyframe ATE and the fused map's structure, launches held to
     ``server_want``; walls per frame, ingest and mapping step, of the
     merging ``try_match``, its ``correct_loop`` and the merge and final
     GBAs (device time, CG steps), and the merging ``try_match`` replayed
     under the profiler;
 14. the landmark-sharded GBA (``parallel.dist_ba``) at world size 1 over
     NCCL: ``__graft_entry__.dryrun_multichip``'s problem (C=256, P=32,768,
     K=4, PCG) and ``scripts/dist_worker.py``'s (C=64, P=4,096, K=4,
     dense), each in 3 chunks of 4 iterations against one of 12 and
     against ``ba_solve``, launches held exactly; wall per LM iteration
     beside ``ba_solve``'s and the device busy share; then phase 13's merged
     slot solved again with ``Server.mesh`` set, held to the unsharded
     solve's cost and to phase 13's ATE gates;
 15. the entry points a user types, on ``cuda:0``: (a) the runner
     in-process, ``run.main`` over 60 rendered corridor frames at 752x480
     with the server, trimming and vicinity feedback, counted; its files
     (KF_GBA_0.csv the server's trajectory, the checkpoint clean, the
     cloud and scene parsed) and its printed ATE (below 0.02 span + 0.05 m,
     for want of a JAX figure of that run) checked; (b) the deployment as
     processes: ``deploy launch --agents 2`` (synthetic, all three
     processes on the card) held to ``tests/test_multiprocess.py``'s gates,
     then a server and a sequence-streaming client over 60 rendered frames
     at 752x480, held to its second test's gates; every process's launches
     (reported in its closing event) held to its work, and together they
     launch every kernel the runner did;
 16. the vocabulary trainer: ``train_vocab.main`` in process on cuda:0 at
     the reference's settings (6 sequences x 48 rendered frames at
     752x480, 600 features each, 32,768 words x 6 iterations) into a
     temporary file, its ``hamming_top2`` launches held to 6 per 8,192
     descriptors; then ``tests/test_vocab_recall.py``'s protocol and gates
     (same-place recall, cross-world margin, distinct words) on the
     held-out seeds 10 and 11 for the trained codebook and the checked-in
     vocab32k, one ``hamming_top2`` per frame and codebook; walls of
     collection and training by CUDA events.

It prints one line per step with each phase's wall time, the card's name and
power limit as ``nvidia-smi`` reports them, on the line before the last
``{"kernels": [...]}`` (each kernel's launches on its path, in phase
14 (``launches_sharded_gba``), in phase 15 (``launches_runner``,
``launches_deploy``) and in phase 16 (``launches_train_vocab``), error against
its plain version, device time, plain time, bound and library yardstick),
and last ``{"ok": true, "device": {...}}``.  Kernel times are the
profiler's device time per wrapper call (``tools/kernel_timing.py``);
where the profiler's kernel count per call disagrees with the wrapper's
launches in three windows (it loses events now and then), the CUDA-event
time stands in, and its log line and its ``ms_by`` key say "events".

Exits non-zero, printing no result, when no CUDA device is present or any
phase fails.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ccm_slam_tpu_torch import config, convert, deploy, native, problems, run, train_vocab
from ccm_slam_tpu_torch.io import checkpoint
from ccm_slam_tpu_torch.io.rendered import RenderedSequence
from ccm_slam_tpu_torch.io.trajectory import ate_rmse, camera_centers, write_tum
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.ops import _build, ba_kernels as bk, hamming, hamming_kernels as hk
from ccm_slam_tpu_torch.ops import initializer, matching, orb, pnp
from ccm_slam_tpu_torch.profile_gba import profile_gba
from ccm_slam_tpu_torch.ops import bow
from ccm_slam_tpu_torch.parallel import dist_ba
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime import loop_closing, map_matching, mapping, tracking, wire
from ccm_slam_tpu_torch.runtime.frame import build_frame
from ccm_slam_tpu_torch.runtime.loop_closing import LoopFinder
from ccm_slam_tpu_torch.runtime.server import Server
from ccm_slam_tpu_torch.runtime.standalone import StandaloneSystem
from ccm_slam_tpu_torch.runtime.tracker import LOST, OK, Tracker
from ccm_slam_tpu_torch.solvers import ba, pose_graph, pose_opt
from ccm_slam_tpu_torch.utils.camera import Camera
from tools import mma_b1_rate
from tools.kernel_timing import (HUBER, blocks_entry, broadcast_entry, cost_entry,
                                 device_events, log, off_entry, problem_args, reduce_entry,
                                 rhs_wtv_entry, schur_inputs, time_table, top2_inputs,
                                 top2_plain_rows, top2_timing)

CG_ITERS = 16              # ba_solve's cap on CG steps per LM iteration
SOURCE = "ccm_slam_tpu_torch/csrc/ba_kernels.cu"
HAMMING_SOURCE = "ccm_slam_tpu_torch/csrc/hamming_kernels.cu"
PALLAS = "ccm_slam_tpu/ops/pallas_kernels.py"
# (name, the TPU kernel's pallas_call it replaces)
KERNELS = [
    ("reproj_cost", f"{PALLAS}:1097"),
    ("normal_blocks", f"{PALLAS}:967"),
    ("schur_off", f"{PALLAS}:634"),
    ("schur_rhs", f"{PALLAS}:648"),
    ("schur_wtv", f"{PALLAS}:660"),
    ("cam_broadcast", f"{PALLAS}:324"),
]

# the __global__ functions of csrc/ba_kernels.cu and csrc/hamming_kernels.cu
# (without the _kernel suffix; schur_point is one template for off, rhs and wtv)
CUDA_KERNELS = ("reproj_cost", "normal_blocks_point", "normal_blocks_camera",
                "normal_blocks_finish", "sum_partials", "schur_point", "schur_off_combine",
                "cam_broadcast", "cam_broadcast_any", "cam_reduce", "cam_reduce_combine",
                "top2")
# the bootstrap pair and the relocalization frame of
# RenderedSequence("corridor", seed=0, n_frames=200, span=(0, 0.22)), and the
# JAX package's own errors on that pair against ground truth (rotation,
# translation direction; degrees), from ``python3 tools/jax_init_pair.py``
INIT_PAIR = (0, 6)
RELOC_FRAME = 10
JAX_PAIR_ERR_DEG = (0.1228, 1.4517)
MIN_ERR_GATE_DEG = (0.5, 5.0)

# phase 11: the client loop over the same sequence, and the JAX package's own
# keyframe ATE on it at 752x480 (rendered_ci_config(1.0), Sim(3)-aligned;
# ``python3 tools/jax_client_ate.py --factor 1.0``: 199 of 200 frames
# tracked, not LOST, 35 keyframes, span 18.848 m)
CLIENT_FRAMES = 200
JAX_CLIENT_ATE_M = 0.05348373204469681
PROFILED_FRAMES = (150, 151, 152)  # frames run under torch.profiler
# phase 12: the standalone system on RenderedSequence("loop", seed=0,
# n_frames=340, span=(0, 1.08)) at 752x480, and the JAX package's own run of
# it (``python3 tools/jax_loop_ate.py --factor 1.0``, JAX on the CPU: 339 of
# 340 frames tracked, not LOST, 1 loop closed, 2 GBA runs, 137 keyframes,
# keyframe ATE 0.1816 m after the final run_gba(40) over a 37.72 m span)
LOOP_FRAMES = 340
JAX_LOOP_ATE_M = 0.18155796825885773
# phase 13: two agents on RenderedSequence("corridor", seed=0, n_frames=120)
# over the spans below, the server merging their maps, and the JAX package's
# own keyframe ATE per agent on that run at 752x480 (``python3
# tools/jax_merge_ate.py --factor 1.0``, JAX on the CPU: 119 of 120 frames
# tracked per agent, merged at step 51 on keyframes (0, 18) and (1, 1), 25
# and 19 keyframes, spans 13.673 m and 13.580 m)
MERGE_FRAMES = 120
MERGE_SPANS = ((0.0, 0.16), (0.08, 0.24))
JAX_MERGE_ATE_M = (0.062455903738737106, 0.05848011001944542)
CAMERA_PERIOD_MS = 50.0            # EuRoC's 20 fps
PROFILE_REPS = 20                  # phase 10: profile_gba repetitions

# Tolerances, kernel against plain version (both fp32 on the card).  Sums
# are taken in another order (CSR segments and tree sums against index_add_
# and einsum), so sums get a tolerance scaled by the largest entry; the
# elementwise outputs (W, the broadcast) carry only FMA-contraction noise.
TOL_BLOCKS = 5e-3      # rtol for U, V, W, g_c, g_p (atol 1e-5 * max|ref|)
TOL_COST = 1e-4        # relative, on the Huber cost sum (+1e-2 absolute)
TOL_SCHUR = 1e-4       # rtol for off/rhs/wtv (atol 1e-4 * max|ref|)
TOL_REDUCE = 1e-4      # rtol for cam_reduce (atol 1e-5 * max|ref|)


_PHASE_T0 = [time.perf_counter()]


def phase_done(n: int) -> None:
    """Log phase n's wall time (since the previous phase ended)."""
    now = time.perf_counter()
    log(f"[phase {n}] done in {now - _PHASE_T0[0]:.1f} s")
    _PHASE_T0[0] = now


class RenderedFrames(dict):
    """Frames of a RenderedSequence, rendered on first use and kept."""

    def __init__(self, seq):
        super().__init__()
        self.seq = seq

    def __missing__(self, i):
        self[i] = self.seq.render_frame(i)
        return self[i]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(name, out, ref, rtol, atol_scale):
    """max abs error and error relative to max|ref|; raises past tolerance."""
    out = out.detach().double().cpu()
    ref = ref.detach().double().cpu()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = (out - ref).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    bound = rtol * ref.abs() + atol_scale * scale + 1e-6
    ok = bool(torch.all(err <= bound)) and bool(torch.isfinite(out).all())
    log(f"  {name:<22} max_abs {max_abs:.3e}  max_rel {max_abs / max(scale, 1e-30):.3e}"
        f"  (rtol {rtol:g}, atol {atol_scale:g}*max|ref|)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def compare_cost(name, out, ref):
    out, ref = float(out), float(ref)
    err = abs(out - ref)
    ok = np.isfinite(out) and err <= TOL_COST * abs(ref) + 1e-2
    log(f"  {name:<22} kernel {out:.6f} plain {ref:.6f} abs {err:.3e}"
        f" (tol {TOL_COST:g}*|ref| + 1e-2)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel cost disagrees with its plain version")
    return err


def check_kernels(prob, rng, label):
    """Every kernel against its plain version on ``prob``; returns
    {kernel: max_abs_err} and the inputs used, for timing."""
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    dev = prob.R.device
    log(f"[kernels] {label}: C={C} P={P} K={K}")
    intr = prob.intr.contiguous()
    csr = bk.cam_csr(prob.cam_idx, C)
    errs = {}

    def rerun(name, fn, out):
        """No float atomics: a second call gives the same bits."""
        again = fn()
        outs = out if isinstance(out, tuple) else (out,)
        agains = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(outs, agains)):
            raise AssertionError(f"{name}: rerun not bit-identical")

    def cost_fn():
        return bk.reproj_cost(*problem_args(prob), intr, HUBER)

    def blocks_fn():
        return bk.normal_blocks(*problem_args(prob), prob.cam_fixed, intr, HUBER, csr)

    cost_k = cost_fn()
    cost_p = bk.reproj_cost_plain(*problem_args(prob), intr, HUBER)
    errs["reproj_cost"] = compare_cost("reproj_cost", cost_k, cost_p)
    rerun("reproj_cost", cost_fn, cost_k)

    out_k = blocks_fn()
    out_p = bk.normal_blocks_plain(*problem_args(prob), prob.cam_fixed, intr, HUBER)
    nb_err = 0.0
    for part, a, b in zip(("U", "V", "W", "g_c", "g_p"), out_k[:5], out_p[:5]):
        nb_err = max(nb_err, compare(f"normal_blocks.{part}", a, b, TOL_BLOCKS, 1e-5))
    compare_cost("normal_blocks.cost", out_k[5], out_p[5])
    log(f"  reproj_cost equals normal_blocks.cost bit for bit: {torch.equal(cost_k, out_k[5])}")
    errs["normal_blocks"] = nb_err
    rerun("normal_blocks", blocks_fn, out_k)
    U, V, W = out_k[0], out_k[1], out_k[2]
    fixed = prob.cam_fixed.nonzero().flatten()
    if fixed.numel() and (float(U[fixed].abs().max()) != 0.0
                          or float(out_k[3][fixed].abs().max()) != 0.0):
        raise AssertionError("normal_blocks: fixed cameras must get zero U and g_c")

    Vinv = ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=dev))).contiguous()
    v = torch.as_tensor(rng.standard_normal((C, 6)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.standard_normal((P, 3)).astype(np.float32), device=dev)
    ops_k = bk.schur_ops(W, Vinv, csr)
    ops_p = bk.schur_ops_plain(W, Vinv, prob.cam_idx, C)
    for name, fk, fp, x in zip(("schur_off", "schur_rhs", "schur_wtv"), ops_k, ops_p,
                               (v, q, v)):
        out = fk(x)
        errs[name] = compare(name, out, fp(x), TOL_SCHUR, 1e-4)
        rerun(name, lambda: fk(x), out)

    # on the path the broadcast carries the 12 pose floats (R | t) per camera
    ci = csr.ci.reshape(-1)
    Rt = torch.cat([prob.R.reshape(C, 9), prob.t], dim=-1).contiguous()
    out = bk.cam_broadcast(Rt, ci)
    errs["cam_broadcast"] = compare("cam_broadcast", out, bk.cam_broadcast_plain(Rt, ci),
                                    0.0, 0.0)
    rerun("cam_broadcast", lambda: bk.cam_broadcast(Rt, ci), out)
    torch.cuda.synchronize()
    log("  every kernel above: bit-identical on a rerun  ok")
    inputs = dict(prob=prob, intr=intr, csr=csr, W=W, Vinv=Vinv, v=v, q=q)
    return errs, inputs


def schur_entries(prob, W, Vinv, v, q):
    """``time_table`` entries of ``schur_ops``' off, rhs and wtv on W, Vinv,
    v [C,6] and q [P,3]."""
    return {"schur_off": off_entry(bk, prob, W, Vinv, v),
            "schur_rhs": rhs_wtv_entry(bk, prob, W, Vinv, q, "schur_rhs"),
            "schur_wtv": rhs_wtv_entry(bk, prob, W, Vinv, v, "schur_wtv")}


def kernel_timings(inp):
    """``time_table``'s result for every kernel at the bench shapes,
    cam_reduce included."""
    prob, csr, W, Vinv, v, q = (inp[k] for k in ("prob", "csr", "W", "Vinv", "v", "q"))
    table = {
        "reproj_cost": cost_entry(bk, prob),
        "normal_blocks": blocks_entry(bk, prob, csr),
        **schur_entries(prob, W, Vinv, v, q),
        "cam_broadcast": broadcast_entry(bk, prob, 12),
        "cam_reduce": reduce_entry(bk, prob),
    }
    return time_table(table, prob.cam_idx.numel(), "bench")


def centres(R, t):
    return -torch.einsum("cji,cj->ci", R, t)


def check_solve(label, prob, iters, cost0, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R, t, X, cost, n_good = ba.ba_solve(prob, iters=iters, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cost = float(cost)
    fixed = prob.cam_fixed
    fixed_same = bool(torch.equal(R[fixed], prob.R[fixed])) and bool(
        torch.equal(t[fixed], prob.t[fixed]))
    ok = np.isfinite(cost) and cost < 0.2 * cost0 and fixed_same and int(n_good) > 0
    log(f"  {label}: cost {cost0:.3f} -> {cost:.3f} ({cost / cost0:.4f}x), "
        f"n_good {int(n_good)}, fixed cameras unchanged {fixed_same}, "
        f"{wall * 1e3:.1f} ms ({wall / iters * 1e3:.2f} ms/iter)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: solve failed its checks")
    return R, t, X, cost, wall


def solve_launches(iters, pcg, calls=1, stats=True):
    """The launches a ``ba_solve`` path makes: per call one cost of the entry
    state, and per LM iteration one trial cost and one normal_blocks; on the
    PCG branch only, per iteration one rhs, one wtv and one off for the
    initial residual plus one per CG step (at most CG_ITERS); one broadcast
    per call for the final statistics.  {kernel: n or (lo, hi)}."""
    want = dict(reproj_cost=iters + calls, normal_blocks=iters,
                cam_broadcast=calls if stats else 0)
    if pcg:
        want.update(schur_rhs=iters, schur_wtv=iters,
                    schur_off=(iters, iters * (CG_ITERS + 1)))
    return want


def counted(label, fn, want):
    """Run one path with every launch count set to 0 just before it; read
    the counts just after and hold them to ``want`` (kernels it does not
    name must stay at 0; a callable ``want`` gets fn's result, for paths
    whose counts follow from what they did).  Returns (fn's result, the
    counts)."""
    bk.reset_launch_counts()
    hk.reset_launch_counts()
    out = fn()
    counts = {**bk.launch_counts(), **hk.launch_counts()}
    hold_counts(label, counts, want(out) if callable(want) else want)
    return out, counts


def hold_counts(label, counts, want):
    """Raise unless every count lies in ``want``'s range (0 where it names
    no range)."""
    bad = {}
    for name, n in counts.items():
        w = want.get(name, 0)
        lo, hi = w if isinstance(w, tuple) else (w, w)
        if not lo <= n <= hi:
            bad[name] = f"{n}, expected {w}"
    log(f"  launches, {label}: {json.dumps(counts)}  {'ok' if not bad else 'FAIL'}")
    if bad:
        raise AssertionError(f"{label}: launch counts off: {bad}")


def agree_with_cpu(label, arr, iters):
    """The card's solve against the CPU (plain) solve on a small problem,
    to the bounds of the JAX package's dist-vs-single parity check."""
    out_g = ba.ba_solve(convert.ba_problem_from_numpy(arr, "cuda"), iters=iters)
    out_c = ba.ba_solve(convert.ba_problem_from_numpy(arr, "cpu"), iters=iters)
    cg, cc = float(out_g[3]), float(out_c[3])
    err = float((centres(out_g[0], out_g[1]).cpu() - centres(out_c[0], out_c[1]))
                .norm(dim=-1).max())
    ok = abs(cg - cc) <= 0.05 * cc + 1e-3 and err < 5e-3
    log(f"  {label}: card cost {cg:.4f} cpu cost {cc:.4f}, centre err {err:.2e} "
        f"(tol 0.05*cost+1e-3, 5e-3)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: card and CPU solves disagree")


def time_solve(prob, iters, runs):
    """Wall seconds of ``runs`` solves (after one warm-up), each ending in
    torch.cuda.synchronize()."""
    ba.ba_solve(prob, iters=iters)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        ba.ba_solve(prob, iters=iters)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def profile_solve(prob):
    """Device time of one bench solve under torch.profiler: all device
    kernels (the port's and PyTorch's) against the wall time, and each of
    the port's CUDA kernels on its own."""
    device, wall_ms = device_events(lambda: ba.ba_solve(prob, iters=20))
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if busy_ms <= 0:
        log("[times] profiled solve: device time not measured (no device events)")
        return
    ours_ms = port_kernels_ms(device)
    log(f"[times] profiled solve: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), of it the port's kernels "
        f"{ours_ms:.2f} ms; {sum(e.count for e in device)} device kernels")
    port_kernels_ms(device, "in the solve")


def port_kernels_ms(device, where=None):
    """Device ms of the port's CUDA kernels among profiler events; with
    ``where``, one line per kernel (launches, us each, ms in all)."""
    total = 0.0
    for name in CUDA_KERNELS:
        evs = [e for e in device if f"{name}_kernel" in e.key]
        n = sum(e.count for e in evs)
        us = sum(e.self_device_time_total for e in evs)
        total += us / 1e3
        if n and where:
            log(f"  {where}: {name}_kernel x{n}, {us / n:.2f} us each, {us / 1e3:.3f} ms in all")
    return total


# ---------------------------------------------------------------------------
# The front-end: hamming_top2, the bootstrap and global relocalization.
# ---------------------------------------------------------------------------


def top2_cases(dev):
    """Phase-5 inputs {name: (q, qv, t, tv)}: the relocalization and
    keyframe-pair shapes with a quarter of the targets invalid, a ragged
    case, 30 invalid queries, and a single valid target, each with a
    duplicated target (a tie) and query 0 equal to it (``top2_inputs``);
    then queries at distance 1 from equal targets at 7 and 8 (across two
    8-target MMA tiles) and at the last index of one of the kernel's 8
    target slices and the first of the next; all targets equal; and the
    vocabulary bootstrap's shape (phase 12): 160 keyframe slots x 1,024
    feature slots against 1,024 words, the features of three keyframes
    valid (98% of the queries invalid), every word valid and a copy of a
    valid feature, two words equal; a keyframe's BoW transform against the
    32,768 words of vocab32k, every word valid; a training block of the
    vocabulary trainer (phase 16): 8,192 descriptors against 32,768 words,
    all valid; and an ingest's BoW batch against vocab32k's words
    (``ingest_top2_inputs``, phase 13)."""
    cases = {}
    for i, (name, Q, Tn) in enumerate((
            ("1024x16384", 1024, 16384), ("1024x1024", 1024, 1024),
            ("ragged 100x300", 100, 300), ("30 invalid queries", 128, 256),
            ("one valid target", 64, 500), ("ties at tile and slice edges", 1000, 3001),
            ("all targets equal", 96, 1000), ("bootstrap 163840x1024", 160 * 1024, 1024),
            ("vocab32k 1024x32768", 1024, 32768), ("trainer 8192x32768", 8192, 32768))):
        q, qv, t, tv = top2_inputs(Q, Tn, torch.device("cpu"), seed=5 + i)
        if name.startswith("bootstrap"):
            qv = (torch.arange(Q) < 3 * 1024) & (torch.arange(Q) % 1024 < 1000)
            g = torch.Generator(device="cpu").manual_seed(5 + i)
            valid_rows = torch.nonzero(qv)[:, 0]
            t = q[valid_rows[torch.randperm(len(valid_rows), generator=g)[:Tn]]]
            t[Tn - 1] = t[Tn // 2]
            tv = torch.ones(Tn, dtype=torch.bool)
        if name.startswith("30"):
            qv[-30:] = False
        if name.startswith("one"):
            tv[:] = False
            tv[Tn - 7] = True
        if name.startswith("ties"):
            s = hk.slice_targets(Tn)
            for k, (a, b) in enumerate(((7, 8), (s - 1, s), (3 * s - 1, 3 * s))):
                t[b] = t[a]
                q[1 + k] = t[a]
                q[1 + k, k] ^= 1
                tv[a] = tv[b] = True
        if name.startswith("all"):
            t[:] = t[0]
        if name.startswith("vocab"):  # a BoW transform: every word valid
            tv[:] = True
        if name.startswith("trainer"):  # a training block: every descriptor and word valid
            qv[:] = True
            tv[:] = True
        cases[name] = tuple(x.to(dev) for x in (q, qv, t, tv))
    cases["ingest 80x1024x32768"] = ingest_top2_inputs(dev)
    return cases


def ingest_top2_inputs(dev, live=40, rows=80, seed=21):
    """An ingest's BoW batch (``keyframe_db.batch_vectors``, phase 13):
    ``rows`` keyframe rows of 1,024 feature slots (the pending buffer and a
    message of ``client_pub_max_kfs`` = 40 each), ``live`` of them new
    keyframes with 95% of their features valid; the other rows read arena
    slot 0, as ``batch_vectors`` clamps them (here: copies of row 0).
    Against the 32,768 words of vocab32k, every word valid, two equal."""
    q, _, t, _ = top2_inputs(rows * 1024, 32768, torch.device("cpu"), seed=seed)
    g = torch.Generator(device="cpu").manual_seed(seed)
    qv = torch.rand(rows * 1024, generator=g) < 0.95
    qk, qvk = q.view(rows, 1024, 32), qv.view(rows, 1024)
    qk[live:] = qk[0]
    qvk[live:] = qvk[0]
    tv = torch.ones(t.shape[0], dtype=torch.bool)
    return tuple(x.to(dev) for x in (q, qv, t, tv))


def check_hamming(dev):
    """hamming_top2 against its plain version on every phase-5 case: equal
    outputs, and a second run bit-identical.  Returns the max abs error."""
    err = 0
    for name, args in top2_cases(dev).items():
        out = hk.hamming_top2(*args)
        again = hk.hamming_top2(*args)
        ref = top2_plain_rows(hk, *args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        repeat = all(torch.equal(a, b) for a, b in zip(out, again))
        e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(out, ref))
        err = max(err, e)
        log(f"  hamming_top2 {name:<20} equal to plain {same}, repeatable {repeat}, "
            f"max abs err {e}  {'ok' if same and repeat else 'FAIL'}")
        if not (same and repeat):
            raise AssertionError(f"hamming_top2 {name}: kernel and plain version disagree")
    return err


def rot_err_deg(R, R_gt):
    c = (float(torch.trace(R.double().cpu() @ R_gt.T)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def dir_err_deg(t, t_gt):
    t = t.double().cpu()
    c = float(t @ t_gt) / max(float(t.norm() * t_gt.norm()), 1e-12)
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def relative_gt(seq, i, j):
    """(R, t) with x_j = R x_i + t from the renderer's camera-to-world poses."""
    _, o_i, R_i = seq.gt_pose(i)
    _, o_j, R_j = seq.gt_pose(j)
    R = torch.as_tensor(R_j.T @ R_i, dtype=torch.float64)
    t = torch.as_tensor(R_j.T @ (o_i - o_j), dtype=torch.float64)
    return R, t


class FrontEnd:
    """The client's front-end at EuRoC width on one device: rendered frames
    in, Frames out (``Tracker.process_image``'s extractor settings)."""

    def __init__(self, seq, images, dev):
        self.seq, self.images, self.dev = seq, images, dev
        self.ex, self.cap = config.ExtractorConfig(), config.CapacityConfig()
        self.cam = Camera.from_config(seq.cam, dev)

    def features(self, i, initializing):
        ex = self.ex
        nf = ex.n_features * (ex.init_features_factor if initializing else 1)
        img = torch.as_tensor(self.images[i], device=self.dev)
        return orb.extract(
            img, n_features=min(nf, self.cap.max_keypoints), n_levels=ex.n_levels,
            scale_factor=ex.scale_factor, ini_th=float(ex.ini_th_fast),
            min_th=float(ex.min_th_fast), cell=ex.cell_size, capacity=self.cap.max_keypoints)

    def frame(self, feats, i):
        return build_frame(feats, self.cam, self.seq.gt_pose(i)[0], self.ex.scale_factor)

    def bootstrap(self, generator=None, idx=None):
        """(features, frames, match idx, match ok, initialize_two_view's dict)."""
        feats = [self.features(i, True) for i in INIT_PAIR]
        f1, f2 = (self.frame(f, i) for f, i in zip(feats, INIT_PAIR))
        m_idx, _, m_ok = matching.search_for_initialization(
            f1.xy, f1.desc, f1.valid, f1.angle, f1.octave,
            f2.xy, f2.desc, f2.valid, f2.angle, f2.octave)
        idx_f, idx_h = idx if idx is not None else (None, None)
        out = initializer.initialize_two_view(f1.xy, f2.xy[m_idx], m_ok, self.cam.K,
                                              idx_f=idx_f, idx_h=idx_h, generator=generator)
        return feats, (f1, f2), m_idx, m_ok, out


def compare_features(label, ours, ref):
    """The card's features against the CPU's, to the ORB parity tolerances:
    valid/octave/xy equal on >= 99% of slots; descriptors bit-exact on >= 99%
    of shared keypoints with mean Hamming <= 0.5; angle within 1e-4 rad."""
    ours = {k: getattr(ours, k).cpu() for k in ("valid", "octave", "xy", "desc", "angle")}
    same = ((ours["valid"] == ref.valid) & (ours["octave"] == ref.octave)
            & torch.all(ours["xy"] == ref.xy, dim=1))
    shared = same & ref.valid
    d = hamming.hamming_pairwise(ours["desc"], ref.desc)[shared].float()
    ang = float((ours["angle"] - ref.angle)[shared].abs().max()) if shared.any() else 0.0
    frac, exact = float(same.float().mean()), float((d == 0).float().mean())
    mean = float(d.mean())
    ok = frac >= 0.99 and exact >= 0.99 and mean <= 0.5 and ang <= 1e-4
    log(f"  {label}: slots equal {frac:.4f} (>= 0.99), descriptors bit-exact {exact:.4f} "
        f"(>= 0.99), mean Hamming {mean:.4f} (<= 0.5), max angle diff {ang:.2e} (<= 1e-4)"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: card and CPU features disagree")


def check_bootstrap(seq, images, dev):
    """Phase 6: the bootstrap on the card, gated on ground truth, then the
    same frames through the port on the CPU.  Returns the card's run."""
    fe = FrontEnd(seq, images, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    (feats, frames, m_idx, m_ok, out), _ = counted("bootstrap", lambda: fe.bootstrap(gen), {})
    R_gt, t_gt = relative_gt(seq, *INIT_PAIR)
    e_rot, e_dir = rot_err_deg(out["R"], R_gt), dir_err_deg(out["t"], t_gt)
    gate = [max(2.0 * j, m) for j, m in zip(JAX_PAIR_ERR_DEG, MIN_ERR_GATE_DEG)]
    ok = bool(out["success"]) and e_rot <= gate[0] and e_dir <= gate[1]
    log(f"  frames {INIT_PAIR}: {int(feats[0].n)} / {int(feats[1].n)} features, "
        f"{int(m_ok.sum())} matches, success {bool(out['success'])}, used_h "
        f"{bool(out['used_h'])}, n_good {int(out['n_good'])}; rotation error {e_rot:.4f} deg "
        f"(<= {gate[0]:.3f}), translation direction error {e_dir:.4f} deg (<= {gate[1]:.3f})"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bootstrap failed its ground-truth gates")

    cpu = FrontEnd(seq, images, torch.device("cpu"))
    idx = (initializer.draw_samples(m_ok, 200, 8, gen),
           initializer.draw_samples(m_ok, 200, 4, gen))
    card = fe.bootstrap(idx=idx)
    c_feats, _, _, c_ok, c_out = cpu.bootstrap(idx=tuple(i.cpu() for i in idx))
    for k, i in enumerate(INIT_PAIR):
        compare_features(f"frame {i} card vs cpu", card[0][k], c_feats[k])
    dR = float((card[4]["R"].cpu() - c_out["R"]).abs().max())
    ok = bool(card[4]["success"]) == bool(c_out["success"]) and dR <= 1e-3
    log(f"  two-view on card vs cpu (same samples): success {bool(card[4]['success'])} / "
        f"{bool(c_out['success'])}, matches {int(card[3].sum())} / {int(c_ok.sum())}, "
        f"max |dR| {dR:.2e} (<= 1e-3)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bootstrap on the card disagrees with the CPU")
    return fe, frames, m_idx, m_ok, out


def reloc_tracker(seq, images, dev):
    """A ``Tracker`` (SystemConfig defaults: 1,024 feature slots, a 16,384-
    slot landmark arena) fed frames INIT_PAIR[0], INIT_PAIR[1], ... until it
    bootstraps; its arena is then filled to capacity with seeded random-
    descriptor landmarks behind the camera (alive, never in view), so that
    relocalization brute-matches a client-map-sized arena."""
    cfg = config.SystemConfig()
    tr = Tracker(cfg=cfg, cam=Camera.from_config(seq.cam, dev), device=dev)
    for i in (INIT_PAIR[0], *range(INIT_PAIR[1], RELOC_FRAME)):
        tr.process_image(images[i], seq.gt_pose(i)[0])
        if tr.state == OK:
            break
    if tr.state != OK:
        raise AssertionError("the tracker did not bootstrap on the rendered frames")
    m = tr.map
    n, M = int(m.next_mp), m.mps.capacity
    B = M - n
    g = torch.Generator(device="cpu").manual_seed(11)
    i32 = dict(dtype=torch.int32, device=dev)
    tr.map, _ = ms.add_mappoints(
        m, n_new=torch.tensor(B, **i32),
        pos=torch.tensor([0.0, 0.0, -100.0], device=dev).repeat(B, 1),
        desc=torch.randint(0, 256, (B, 32), generator=g, dtype=torch.uint8).to(dev),
        normal=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(B, 1),
        min_dist=torch.zeros(B, device=dev), max_dist=torch.full((B,), float("inf"), device=dev),
        ref_kf=torch.zeros(B, **i32), mp_ids=torch.arange(n, M, **i32),
        client_id=torch.zeros(B, **i32), new_valid=torch.ones(B, dtype=torch.bool, device=dev))
    return tr, n


def relocalize(tr, frame):
    """The tracker's relocalization of a frame after loss (staged: the
    reference keyframe's covisibility neighborhood, then the whole arena)."""
    tr.state = LOST
    tr.enable_relocalization = True
    return tr.process_frame(frame)


def check_relocalization(fe, seq, images, dev):
    """Phase 7: a later frame relocalized by the Tracker against its filled
    arena; the tracker's own gates (>= 15 matches, >= 15 PnP inliers, >= 30
    local-map inliers) and 1 degree of ground truth."""
    tr, n_map = reloc_tracker(seq, images, dev)
    frame = fe.frame(fe.features(RELOC_FRAME, False), RELOC_FRAME)
    before = tr.stats["brute_matches"]
    out, counts = counted("relocalization", lambda: relocalize(tr, frame),
                          lambda _: {"hamming_top2": tr.stats["brute_matches"] - before})
    if out is None:
        raise AssertionError(f"relocalization failed: {tr.stats.get('reloc_fail')}")
    R_gt, t_gt = relative_gt(seq, INIT_PAIR[0], RELOC_FRAME)
    e_rot, e_dir = rot_err_deg(out.R_cw, R_gt), dir_err_deg(out.t_cw, t_gt)
    tag = tr.stats["reloc_fail"].split(":")[0]
    n_match, n_pnp = tr.stats[f"reloc_{tag}_match"], tr.stats[f"reloc_{tag}_pnp"]
    ok = tr.state == OK and e_rot <= 1.0 and counts["hamming_top2"] >= 1
    log(f"  frame {RELOC_FRAME} vs {tr.map.mps.capacity} landmark slots ({n_map} from the "
        f"bootstrap): stage {tag}, {n_match} matches (>= 15), PnP inliers {n_pnp} (>= 15), "
        f"local-map inliers {tr.stats[f'reloc_{tag}_lm']} (>= 30); rotation error "
        f"{e_rot:.4f} deg (<= 1), translation direction error {e_dir:.4f} deg"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("relocalization failed its gates")
    return tr, frame, counts


def walls_ms(fn, runs=5):
    """Wall ms of ``runs`` calls (after one warm-up), each ending in a sync."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(ms):
    return (f"median {statistics.median(ms):.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}; "
            f"{', '.join(f'{m:.3f}' for m in ms)})")


def front_end_timings(fe, frames, m_idx, m_ok, tr, reloc_frame):
    """Wall ms (5 runs after a warm-up, each ending in a sync) of each
    front-end step at EuRoC width; the arena steps on the phase-7 tracker's
    filled arena."""
    f1, f2 = frames
    cam = fe.cam
    gen = torch.Generator(device=fe.dev).manual_seed(2)
    mps = tr.map.mps
    pos, desc, alive = mps.pos, mps.desc, (mps.valid & ~mps.bad).contiguous()
    t_idx, _, okm = matching.match_brute(reloc_frame.desc, reloc_frame.valid, desc, alive,
                                         check_rotation=False)
    steps = [
        ("orb.extract 752x480, 1024 features, 8 levels",
         lambda: fe.features(INIT_PAIR[0], True)),
        ("search_for_initialization 1024 x 1024",
         lambda: matching.search_for_initialization(
             f1.xy, f1.desc, f1.valid, f1.angle, f1.octave,
             f2.xy, f2.desc, f2.valid, f2.angle, f2.octave)),
        ("initialize_two_view, 200 F + 200 H hypotheses",
         lambda: initializer.initialize_two_view(f1.xy, f2.xy[m_idx], m_ok, cam.K,
                                                 generator=gen)),
        (f"match_brute 1024 x {desc.shape[0]}",
         lambda: matching.match_brute(reloc_frame.desc, reloc_frame.valid, desc, alive,
                                      check_rotation=False)),
        ("ransac_pnp, 200 hypotheses + refine",
         lambda: pnp.ransac_pnp(pos[t_idx], reloc_frame.xy, okm, reloc_frame.sigma2, cam.fx,
                                cam.fy, cam.cx, cam.cy, generator=gen)),
        (f"relocalization against the whole arena ({desc.shape[0]} slots): Tracker._pnp_recover",
         lambda: tr._pnp_recover(reloc_frame, alive, "global")),
    ]
    for label, fn in steps:
        log(f"  {label}: {spread(walls_ms(fn))}")
        device, wall = device_events(fn)
        busy = sum(e.self_device_time_total for e in device) / 1e3
        log(f"    profiled once: wall {wall:.3f} ms (profiler on), device busy {busy:.3f} ms "
            f"({busy / wall:.1%}), {sum(e.count for e in device)} device kernels")


# ---------------------------------------------------------------------------
# Phases 9-10: cam_reduce, make_schur_matvec and the GBA profiling path.
# ---------------------------------------------------------------------------


def reduce_cases(dev):
    """Phase-9 cam_reduce inputs {name: (y, ci, C)}: F=6 (CG vectors) and
    F=42 (U|g_c rows) at the server-GBA (E=262,144, C=128) and stress
    (E=1,048,576, C=1024) shapes with ids in range, and a ragged case with
    ids -1..C+2 (those outside [0, C) must be dropped)."""
    g = torch.Generator(device="cpu").manual_seed(9)
    cases = {}
    for label, E, C in (("server", 262144, 128), ("stress", 1048576, 1024)):
        ci = torch.randint(0, C, (E,), generator=g, dtype=torch.int32).to(dev)
        for F in (6, 42):
            cases[f"{label} E={E} C={C} F={F}"] = (torch.randn(E, F, generator=g).to(dev), ci, C)
    ci = torch.randint(-3, 40, (99991,), generator=g, dtype=torch.int32).to(dev)
    cases["ragged E=99991 C=37 F=13"] = (torch.randn(99991, 13, generator=g).to(dev), ci, 37)
    return cases


def check_cam_reduce(dev):
    """cam_reduce against its plain version (the masked index_add_) on every
    phase-9 case, and bit-identical on a rerun; returns the max abs error."""
    err = 0.0
    for name, (y, ci, C) in reduce_cases(dev).items():
        out, again = bk.cam_reduce(y, ci, C), bk.cam_reduce(y, ci, C)
        err = max(err, compare(f"cam_reduce {name}", out, bk.cam_reduce_plain(y, ci, C),
                               TOL_REDUCE, 1e-5))
        repeat = torch.equal(out, again)
        dropped = int(((ci < 0) | (ci >= C)).sum())
        if dropped:  # the clamping CSR of BA would have folded these in
            clamped = bk.cam_reduce_plain(y, ci.clamp(0, C - 1), C)
            if torch.allclose(out, clamped):
                raise AssertionError("cam_reduce kept rows whose ids are out of range")
        log(f"    repeatable {repeat}, rows dropped {dropped}  {'ok' if repeat else 'FAIL'}")
        if not repeat:
            raise AssertionError(f"cam_reduce {name}: rerun not bit-identical")
    return err


def check_schur_matvec(probs, rng):
    """make_schur_matvec, and schur_ops' rhs and wtv, against their plain
    versions on each problem, bit-identical on a rerun; returns
    make_schur_matvec's max abs error."""
    err = 0.0
    for label, prob in probs.items():
        C, (P, _) = prob.R.shape[0], prob.cam_idx.shape
        W, Vinv = schur_inputs(bk, ba, prob)
        v = torch.as_tensor(rng.standard_normal((C, 6)).astype(np.float32), device=W.device)
        q = torch.as_tensor(rng.standard_normal((P, 3)).astype(np.float32), device=W.device)
        _, rhs_k, wtv_k = bk.schur_ops(W, Vinv, bk.cam_csr(prob.cam_idx, C))
        _, rhs_p, wtv_p = bk.schur_ops_plain(W, Vinv, prob.cam_idx, C)
        off_k = bk.make_schur_matvec(W, Vinv, prob.cam_idx, C)
        off_p = bk.schur_matvec_plain(W, Vinv, prob.cam_idx, C)
        for name, fk, fp, x in (("make_schur_matvec", off_k, off_p, v),
                                ("schur_rhs", rhs_k, rhs_p, q), ("schur_wtv", wtv_k, wtv_p, v)):
            out, again = fk(x), fk(x)
            e = compare(f"{name} {label}", out, fp(x), TOL_SCHUR, 1e-4)
            if name == "make_schur_matvec":
                err = max(err, e)
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {label}: rerun not bit-identical")
    return err


def stress_timings(stress, rng):
    """``time_table``'s result for normal_blocks, cam_reduce, reproj_cost,
    make_schur_matvec, schur_ops' rhs and wtv and cam_broadcast (F=6 and
    F=12) at the stress shape, the profiling path's inputs."""
    C, (P, K) = stress.R.shape[0], stress.cam_idx.shape
    W, Vinv = schur_inputs(bk, ba, stress)
    v = torch.as_tensor(rng.standard_normal((C, 6)).astype(np.float32), device=W.device)
    q = torch.as_tensor(rng.standard_normal((P, 3)).astype(np.float32), device=W.device)
    table = {
        "normal_blocks": blocks_entry(bk, stress, bk.cam_csr(stress.cam_idx, C)),
        "cam_reduce": reduce_entry(bk, stress),
        "reproj_cost": cost_entry(bk, stress),
        "schur_matvec": off_entry(bk, stress, W, Vinv, v, "schur_matvec"),
        "schur_rhs": rhs_wtv_entry(bk, stress, W, Vinv, q, "schur_rhs"),
        "schur_wtv": rhs_wtv_entry(bk, stress, W, Vinv, v, "schur_wtv"),
        "cam_broadcast F=6": broadcast_entry(bk, stress, 6),
        "cam_broadcast F=12": broadcast_entry(bk, stress, 12),
    }
    return time_table(table, P * K, "stress")


def profile_want(res):
    """The launches of profile_gba's calls: one normal_blocks to set up, and
    per call of each component its own kernels."""
    c = {k: v["calls"] for k, v in res.items()}
    lm = c["lm_iter_full"]
    return dict(
        normal_blocks=1 + c["build_normal_blocks"] + lm,
        reproj_cost=c["cost_eval"] + 2 * lm,
        cam_broadcast=c["schur_matvec"] + c["cam_broadcast_f6"] + lm,
        cam_reduce=c["schur_matvec"] + c["cam_reduce_f6"],
        schur_matvec=c["fused_schur_matvec"],
        schur_rhs=lm, schur_wtv=lm, schur_off=(lm, lm * (CG_ITERS + 1)),
    )


def check_profile(stress):
    """Phase 10: profile_gba at the stress shape, counted; every component's
    time printed.  Returns the counts."""
    res, counts = counted("profile_gba", lambda: profile_gba(stress, reps=PROFILE_REPS),
                          profile_want)
    if not (counts["cam_reduce"] > 0 and counts["schur_matvec"] > 0):
        raise AssertionError("the profiling path launched no cam_reduce / schur_matvec")
    for name, r in res.items():
        ev = f"{r['event_ms']:.4f}" if r["event_ms"] is not None else "n/a"
        log(f"  {name:<20} {r['ms']:.4f} ms per call ({r['how']}; {ev} ms by CUDA events "
            f"over back-to-back calls), {r['calls']} calls")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: the single-agent client loop at full width.
# ---------------------------------------------------------------------------


def client_want(s):
    """The kernel launches of a Tracker run, from what the tracker counted
    (its ``stats``): each initialization's 20-iteration BA (160 camera
    slots: the PCG branch, as in the reference), each local BA's iterations
    (40 camera slots: dense), one hamming_top2 per brute match."""
    init, lba, lba_it = s["init_calls"], s["local_ba_calls"], s["local_ba_iters"]
    return dict(
        normal_blocks=20 * init + lba_it,
        reproj_cost=21 * init + lba_it + lba,
        cam_broadcast=init + 2 * lba,  # final statistics; local BA's outlier pass
        schur_rhs=20 * init, schur_wtv=20 * init,
        schur_off=(20 * init, 20 * (CG_ITERS + 1) * init),
        hamming_top2=s["brute_matches"],
    )


def profiled(fn):
    """(fn's result, device events, wall ms) of one call under the profiler."""
    box = []
    device, wall = device_events(lambda: box.append(fn()))
    return box[0], device, wall


def kf_trajectory(m):
    """(timestamps, camera centres) of the alive keyframes by keyframe id."""
    alive = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
    idx = np.where(alive)[0]
    idx = idx[np.argsort(m.kfs.kf_id.cpu().numpy()[idx])]
    sel = torch.as_tensor(idx, device=m.kfs.R_cw.device)
    ctr = camera_centers(m.kfs.R_cw[sel], m.kfs.t_cw[sel]).cpu().numpy()
    return m.kfs.timestamp.cpu().numpy()[idx], ctr


def check_client_loop(dev, smi):
    """Phase 11: Tracker.process_image over CLIENT_FRAMES rendered 752x480
    corridor frames (rendered on the card before the loop), counted; gated
    on LOST, frames tracked and keyframe ATE.  Returns the counts and the
    median per-frame wall (ms)."""
    cfg = config.rendered_ci_config(factor=1.0)
    seq = RenderedSequence(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22),
                           cam=cfg.camera, backend="torch", device=dev)
    t0 = time.perf_counter()
    images = [seq.render_frame(i) for i in range(CLIENT_FRAMES)]
    torch.cuda.synchronize()
    log(f"  rendered {CLIENT_FRAMES} frames {tuple(images[0].shape)} on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    stamps = [seq.gt_pose(i)[0] for i in range(CLIENT_FRAMES)]
    tr = Tracker(cfg=cfg, cam=Camera.from_config(cfg.camera, dev), device=dev)
    walls, prof = [], []

    def drive():
        tracked = 0
        for i in range(CLIENT_FRAMES):
            if i in PROFILED_FRAMES:
                out, device, wall = profiled(lambda: tr.process_image(images[i], stamps[i]))
                prof.append((i, device, wall, tr.stats["path"]))
            else:
                t1 = time.perf_counter()
                out = tr.process_image(images[i], stamps[i])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
            tracked += out is not None
        return tracked

    t0 = time.perf_counter()
    reads0 = tr.stats["host_reads"]
    tracked, counts = counted("client loop", drive, lambda _: client_want(tr.stats))
    loop_s = time.perf_counter() - t0
    if counts["hamming_top2"] < 1:
        raise AssertionError("the client loop never tracked against its reference keyframe")
    ts, est = kf_trajectory(tr.map)
    gt_ts, gt_pos, _ = seq.ground_truth()
    gt = gt_pos[np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)]
    rmse, _ = ate_rmse(est, gt, align="sim3")
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    gate = max(0.010 * span + 0.02, 2.0 * JAX_CLIENT_ATE_M)
    ok = tr.state != LOST and tracked >= 0.8 * CLIENT_FRAMES and rmse < gate
    s = tr.stats
    log(f"  {tracked}/{CLIENT_FRAMES} frames tracked (>= {0.8 * CLIENT_FRAMES:.0f}), state "
        f"{['NOT_INITIALIZED', 'OK', 'LOST'][tr.state]} (not LOST), {len(ts)} keyframes "
        f"({s['kf_created']} created), {s['mp_created']} landmarks created; keyframe ATE "
        f"{rmse:.4f} m over a {span:.3f} m span (gate {gate:.4f} m = max(0.010 span + 0.02, "
        f"2 x the JAX package's {JAX_CLIENT_ATE_M:.4f} m))  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the client loop failed its gates")
    med = statistics.median(walls)
    log(f"[times] client loop, {smi}: {loop_s:.1f} s for {CLIENT_FRAMES} frames; per-frame wall "
        f"(unprofiled frames, each ending in a sync) median {med:.3f} ms, min {min(walls):.3f}, "
        f"max {max(walls):.3f}, {sum(w <= CAMERA_PERIOD_MS for w in walls)}/{len(walls)} "
        f"within the {CAMERA_PERIOD_MS:g} ms camera period; host reads "
        f"{s['host_reads'] - reads0} ({(s['host_reads'] - reads0) / CLIENT_FRAMES:.1f} per "
        f"frame); initializations {s['init_calls']}, local BAs {s['local_ba_calls']}, "
        f"brute matches {s['brute_matches']}")
    for i, device, wall, path in prof:
        busy = sum(e.self_device_time_total for e in device) / 1e3
        log(f"  profiled frame {i} (path {path}): wall {wall:.3f} ms (profiler on), device busy "
            f"{busy:.3f} ms ({busy / wall:.1%}), {sum(e.count for e in device)} device kernels")
    last_kf = int(torch.max(torch.where(tr.map.kfs.valid & ~tr.map.kfs.bad,
                                        torch.arange(tr.map.kfs.capacity, device=dev), -1)))
    frame = tr.last_frame
    for label, fn in (
            (f"track_local_map ({tr.map.mps.capacity} landmark slots x {frame.n_feat} features)",
             lambda: tracking.track_local_map(tr.map, frame, tr.cam, cfg)),
            (f"local_ba (15 iterations, keyframe slot {last_kf})",
             lambda: mapping.local_ba(tr.map, last_kf, tr.cam, cfg))):
        log(f"  {label}: {spread(walls_ms(fn, 3))}")
        _, device, wall = profiled(fn)
        busy = sum(e.self_device_time_total for e in device) / 1e3
        log(f"    profiled once: wall {wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.1%}), "
            f"{sum(e.count for e in device)} device kernels, the port's CUDA kernels "
            f"{port_kernels_ms(device):.3f} ms")
        port_kernels_ms(device, "    in it")
    return counts, med


# ---------------------------------------------------------------------------
# Phase 12: the single-agent loop (StandaloneSystem) at full width.
# ---------------------------------------------------------------------------


class StageWalls:
    """Wall ms of named calls, the device synchronized before and after each:
    wraps module functions and class methods for one phase, and restores
    them."""

    def __init__(self):
        self.ms, self._undo = {}, []

    def wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def loop_want(sys_):
    """The kernel launches of a StandaloneSystem run, from what it counted:
    the tracker's (``client_want``), per GBA of n iterations at 160 keyframe
    slots the PCG branch's ``solve_launches(n)``, and one hamming_top2 per
    ``estimate_sim3`` attempt (its ``match_brute``), per BoW transform and per
    vocabulary training iteration (each takes its nearest words from it)."""
    want = client_want(sys_.tracker.stats)
    gba = solve_launches(sys_.stats["gba_iters"], pcg=True, calls=sys_.stats["gba_runs"])
    for name, n in gba.items():
        lo, hi = n if isinstance(n, tuple) else (n, n)
        w = want.get(name, 0)
        wlo, whi = w if isinstance(w, tuple) else (w, w)
        want[name] = (wlo + lo, whi + hi)
    f = sys_.finder.stats
    want["hamming_top2"] += f["sim3_attempts"] + f["bow_transforms"] + sys_.stats["vocab_iters"]
    return want


def check_standalone_loop(dev, smi):
    """Phase 12: StandaloneSystem.process_image over LOOP_FRAMES rendered
    752x480 loop-circuit frames, then run_gba(40), counted; gated as the JAX
    package's rendered loop gate (tests/test_rendered_loop.py:34-58) plus
    twice the JAX package's own ATE.  Returns the counts."""
    cfg = config.rendered_ci_config(factor=1.0)
    seq = RenderedSequence(world="loop", seed=0, n_frames=LOOP_FRAMES, span=(0.0, 1.08),
                           cam=cfg.camera, backend="torch", device=dev)
    t0 = time.perf_counter()
    images = [seq.render_frame(i) for i in range(LOOP_FRAMES)]
    torch.cuda.synchronize()
    log(f"  rendered {LOOP_FRAMES} frames {tuple(images[0].shape)} on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    stamps = [seq.gt_pose(i)[0] for i in range(LOOP_FRAMES)]
    sys_ = StandaloneSystem(cfg=cfg, cam=Camera.from_config(cfg.camera, dev), n_words=1024,
                            device=dev)
    walls, gbas, closing = [], [], {}
    stages = StageWalls()
    for owner, attr, name in ((bow, "train_vocabulary", "vocabulary bootstrap"),
                              (LoopFinder, "detect", "try_close stage detect"),
                              (loop_closing, "estimate_sim3", "try_close stage estimate_sim3"),
                              (loop_closing, "guided_projection_count",
                               "try_close stage guided projection"),
                              (loop_closing, "correct_loop", "try_close stage correct_loop"),
                              (pose_graph, "optimize_pose_graph",
                               "correct_loop's pose graph")):
        stages.wrap(owner, attr, name)
    run_gba = sys_.run_gba

    def traced_gba(iters=20):
        """Each GBA's wall, device time (profiler) and CG steps (schur_off
        launches less the one per LM iteration for the initial residual)."""
        off0 = bk.launch_counts()["schur_off"]
        cost, device, wall = profiled(lambda: run_gba(iters))
        busy = sum(e.self_device_time_total for e in device) / 1e3
        gbas.append((iters, wall, busy, bk.launch_counts()["schur_off"] - off0 - iters,
                     sum(e.count for e in device)))
        return cost

    sys_.run_gba = traced_gba

    def snapshot_closing(finder):
        """Keep the inputs of the first try_close that closes, for a replay
        under the profiler after the counted run."""
        try_close = finder.try_close

        def wrapped(m, kf_idx, sample=None):
            state = dict(m=m, kf_idx=kf_idx, db=finder.db, prev=list(finder.prev_groups),
                         last=finder.last_loop_kf_id, rng=finder.rng.get_state())
            out = try_close(m, kf_idx, sample)
            if out[1] and not closing:
                closing.update(state)
            return out

        finder.try_close = wrapped

    def drive():
        tracked, wrapped = 0, False
        for i in range(LOOP_FRAMES):
            t1 = time.perf_counter()
            out = sys_.process_image(images[i], stamps[i])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            tracked += out is not None
            if sys_.finder is not None and not wrapped:
                snapshot_closing(sys_.finder)
                wrapped = True
        in_run = dict(sys_.stats)
        sys_.run_gba(40)  # the final GBA on quiescence (Communicator.cpp:456-480)
        return tracked, in_run

    t0 = time.perf_counter()
    try:
        (tracked, in_run), counts = counted("standalone loop", drive,
                                            lambda _: loop_want(sys_))
    finally:
        stages.restore()
    loop_s = time.perf_counter() - t0
    m = sys_.tracker.map
    alive = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
    edge_kfs = int((alive & (m.kfs.loop_edges.cpu().numpy() >= 0).any(1)).sum())
    structure = ms.check_structure(m)
    ts, est = kf_trajectory(m)
    gt_ts, gt_pos, _ = seq.ground_truth()
    gt = gt_pos[np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)]
    rmse, _ = ate_rmse(est, gt, align="sim3")
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    gate = max(0.115 * span + 0.05, 2.0 * JAX_LOOP_ATE_M)
    f = sys_.finder.stats
    ok = (sys_.tracker.state != LOST and tracked >= 0.8 * LOOP_FRAMES
          and in_run["loops_closed"] >= 1 and in_run["gba_runs"] >= 1 and edge_kfs >= 2
          and structure == [] and rmse < gate and f["sim3_attempts"] >= 1)
    s = sys_.tracker.stats
    log(f"  {tracked}/{LOOP_FRAMES} frames tracked (>= {0.8 * LOOP_FRAMES:.0f}), state "
        f"{['NOT_INITIALIZED', 'OK', 'LOST'][sys_.tracker.state]} (not LOST); "
        f"{in_run['loops_closed']} loop(s) closed and {in_run['gba_runs']} GBA(s) in the run "
        f"(>= 1 each), {f['sim3_attempts']} estimate_sim3 attempts, {f['bow_transforms']} BoW "
        f"transforms; {edge_kfs} alive keyframes with a loop edge (>= 2); check_structure "
        f"{len(structure)} findings (0); {len(ts)} keyframes alive ({s['kf_created']} created); "
        f"keyframe ATE after run_gba(40) {rmse:.4f} m over a {span:.3f} m span (gate "
        f"{gate:.4f} m = max(0.115 span + 0.05, 2 x the JAX package's {JAX_LOOP_ATE_M:.4f} m))"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the standalone loop failed its gates: {structure[:5]}")
    med = statistics.median(walls)
    log(f"[times] standalone loop, {smi}: {loop_s:.1f} s for {LOOP_FRAMES} frames and the final "
        f"GBA; per-frame wall (each ending in a sync) median {med:.3f} ms, min {min(walls):.3f}, "
        f"max {max(walls):.3f}, {sum(w <= CAMERA_PERIOD_MS for w in walls)}/{len(walls)} within "
        f"the {CAMERA_PERIOD_MS:g} ms camera period; host reads: tracker {s['host_reads']}, loop "
        f"closer {f['host_reads']}; local BAs {s['local_ba_calls']}, brute matches "
        f"{s['brute_matches']}")
    for name, ws in stages.ms.items():
        log(f"  {name}, {smi}: {len(ws)} call(s), median {statistics.median(ws):.3f} ms, "
            f"min {min(ws):.3f}, max {max(ws):.3f}, total {sum(ws):.1f}")
    for k, (iters, wall, busy, cg, n_k) in enumerate(gbas):
        log(f"  GBA {k + 1} ({iters} iterations, {smi}): wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms ({busy / wall:.1%}), {cg} CG steps, {n_k} device kernels")
    if closing:
        lf = LoopFinder(cfg=cfg, cam=sys_.cam, vocab=sys_.vocab, db=closing["db"], map_id=0,
                        last_loop_kf_id=closing["last"], prev_groups=closing["prev"],
                        rng=torch.Generator(device=dev))
        lf.rng.set_state(closing["rng"])
        (_, closed), device, wall = profiled(lambda: lf.try_close(closing["m"],
                                                                   closing["kf_idx"]))
        busy = sum(e.self_device_time_total for e in device) / 1e3
        log(f"  closing try_close replayed under the profiler ({smi}): closed again {closed}, "
            f"wall {wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.1%}), "
            f"{sum(e.count for e in device)} device kernels, the port's CUDA kernels "
            f"{port_kernels_ms(device):.3f} ms")
        if not closed:
            raise AssertionError("the closing try_close did not close again on its replay")
        for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.key[:70]:<70} x{e.count} {e.self_device_time_total / 1e3:.3f} ms")
    return counts


# ---------------------------------------------------------------------------
# Phase 13: two rendered agents merge on the server at full width.
# ---------------------------------------------------------------------------


def server_want(srv, trackers):
    """The kernel launches of a two-agent server run, from what it counted:
    each tracker's (``client_want``); per GBA of n iterations on C camera
    slots ``solve_launches(n)`` on its branch (PCG above ``pcg_min_c()``),
    with the final statistics unless it was an interruptible chunk; one
    hamming_top2 per BoW batch (each ingest's, the matcher's and the loop
    finders' transforms) and per ``estimate_sim3`` attempt (loop finders and
    matcher)."""
    want = {}
    for tr in trackers:
        add_want(want, client_want(tr.stats))
    searches = [srv.matcher.stats] + [f.stats for f in srv.finders.values()]
    work = {k: sum(s[k] for s in searches) for k in ("bow_transforms", "sim3_attempts")}
    add_want(want, server_work_want(dict(gba=srv.stats["gba"],
                                         bow_batches=srv.stats["bow_batches"], **work)))
    return want


def add_want(want, part):
    """Add the expected counts ``part`` to ``want`` ({kernel: (lo, hi)})."""
    for name, n in part.items():
        lo, hi = n if isinstance(n, tuple) else (n, n)
        w = want.get(name, 0)
        wlo, whi = w if isinstance(w, tuple) else (w, w)
        want[name] = (wlo + lo, whi + hi)


def server_work_want(work):
    """The launches a server's own work makes, from its counts (as the
    deployment's ``run_summary`` reports them): per GBA ``solve_launches``
    on its branch, one hamming_top2 per BoW batch, BoW transform and Sim(3)
    attempt."""
    want = {}
    for iters, C, stats in work["gba"]:
        add_want(want, solve_launches(iters, pcg=C > ba.pcg_min_c(), stats=stats))
    add_want(want, {"hamming_top2": work["bow_batches"] + work["bow_transforms"]
                    + work["sim3_attempts"]})
    return want


def merge_ates(srv, seqs):
    """Each agent's (keyframe ATE, span, gate, keyframes) on the server's
    map: Sim(3)-aligned against ground truth, gated at max(0.02 span + 0.05,
    2 x the JAX package's)."""
    ates = []
    for i in (0, 1):
        ts, R, t = srv.trajectory(i)
        est = camera_centers(torch.as_tensor(R), torch.as_tensor(t)).numpy()
        gt_ts, gt_pos, _ = seqs[i].ground_truth()
        gt = gt_pos[np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)]
        rmse, _ = ate_rmse(est, gt, align="sim3")
        span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
        gate = max(0.02 * span + 0.05, 2.0 * JAX_MERGE_ATE_M[i])
        ates.append((rmse, span, gate, len(ts)))
    return ates


def check_two_agent_merge(dev, smi):
    """Phase 13: the drive loop of tests/test_rendered_merge.py at 752x480 --
    two agents over overlapping corridor spans, each publishing every 4th
    step through the wire codec both ways, the server ingesting, running
    ``mapping_step`` per new keyframe and ``idle_step`` every step, then
    ``quiescence_steps + 2`` more; counted.  Gated on the merge (both agents
    in one slot), each agent's keyframe ATE (max(0.02 span + 0.05, 2 x the
    JAX package's)) and the fused map's structure.  Returns the counts, the
    server, the two sequences and {slot: (map, map)}: each slot's map at the
    entry and at the exit of its last 20-iteration GBA."""
    cfg = config.rendered_ci_config(factor=1.0)
    cfg = cfg.replace(n_agents=2, placerec=dataclasses.replace(
        cfg.placerec, start_map_matching_after_kf=5))
    cam = Camera.from_config(cfg.camera, dev)
    seqs = [RenderedSequence(world="corridor", seed=0, n_frames=MERGE_FRAMES, span=sp,
                             cam=cfg.camera, backend="torch", device=dev) for sp in MERGE_SPANS]
    t0 = time.perf_counter()
    images = [[s.render_frame(i) for i in range(MERGE_FRAMES)] for s in seqs]
    torch.cuda.synchronize()
    log(f"  rendered 2 x {MERGE_FRAMES} frames {tuple(images[0][0].shape)} on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    stamps = [[s.gt_pose(i)[0] for i in range(MERGE_FRAMES)] for s in seqs]
    vocab = bow.load_vocabulary(device=dev)
    srv = Server(cfg=cfg, cam=cam, vocab=vocab, n_agents=2, device=dev)
    trackers = [Tracker(cfg=cfg, cam=cam, client_id=i, device=dev) for i in range(2)]
    states = [comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                          cfg.capacity.client_max_mps) for _ in range(2)]
    stages = StageWalls()
    for owner, attr, name in ((Server, "ingest", "ingest"),
                              (Server, "mapping_step", "mapping_step"),
                              (map_matching, "correct_loop", "the merge's correct_loop")):
        stages.wrap(owner, attr, name)
    merge, gbas, frame_walls, last_gba = {}, [], [], {}
    try_match, run_gba = srv.matcher.try_match, srv._run_gba
    step_now = [0]

    def traced_try_match(slot, m_a, kf_idx, maps, sample=None):
        state = dict(db=srv.matcher.db, kf_capacity=srv.matcher.kf_capacity,
                     rng=srv.matcher.rng.get_state(), args=(slot, m_a, kf_idx, dict(maps)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = try_match(slot, m_a, kf_idx, maps, sample)
        torch.cuda.synchronize()
        if res is not None and not merge:
            k_q, k_c = res.kf_pair
            kf_id, cl = res.fused.kfs.kf_id.cpu().numpy(), res.fused.kfs.client_id.cpu().numpy()
            merge.update(state, step=step_now[0], wall=(time.perf_counter() - t1) * 1e3,
                         pair=((int(cl[k_q]), int(kf_id[k_q])), (int(cl[k_c]), int(kf_id[k_c]))))
        return res

    def traced_gba(slot, iters, with_stats=True, carry=False, block=True):
        """20-iteration GBAs (the merge GBA, the final GBA) under the
        profiler: wall, device time, CG steps; chunks run as they are."""
        if carry:
            return run_gba(slot, iters, with_stats, carry, block)
        off0 = bk.launch_counts()["schur_off"]
        entry = srv.maps[slot]
        cost, device, wall = profiled(lambda: run_gba(slot, iters, with_stats, carry, block))
        last_gba[slot] = (entry, srv.maps[slot])
        busy = sum(e.self_device_time_total for e in device) / 1e3
        label = "merge GBA" if merge and not any(g[0] == "merge GBA" for g in gbas) \
            else "final GBA"
        gbas.append((label, iters, wall, busy, bk.launch_counts()["schur_off"] - off0,
                     sum(e.count for e in device)))
        return cost

    srv.matcher.try_match, srv._run_gba = traced_try_match, traced_gba

    def drive():
        tracked = [0, 0]
        for step in range(MERGE_FRAMES):
            step_now[0] = step
            for i in (0, 1):
                tr = trackers[i]
                t1 = time.perf_counter()
                out = tr.process_image(images[i][step], stamps[i][step])
                torch.cuda.synchronize()
                frame_walls.append((time.perf_counter() - t1) * 1e3)
                tracked[i] += out is not None
                if tr.map is None or step % 4 != 3:
                    continue
                msg, states[i] = comm.publish_client(
                    tr.map, states[i], i, max_kfs=cfg.comm.client_pub_max_kfs,
                    max_mps=cfg.comm.client_pub_max_mps)
                if msg.empty:
                    continue
                msg = wire.unpack_map_msg(wire.pack_map_msg(msg), device=dev)
                new_ids = [int(k) for k, v in zip(msg.kfs.kf_id.cpu().numpy(),
                                                  msg.kfs.valid.cpu().numpy()) if v]
                ack = wire.unpack_map_msg(wire.pack_map_msg(srv.ingest(i, msg)), device=dev)
                states[i] = comm.apply_server_acks(states[i], tr.map, ack)
                ag = srv.agents[i]
                for kf_id in new_ids:
                    if kf_id in ag.kf_table:
                        srv.mapping_step(i, ag.kf_table[kf_id])
            srv.idle_step()
        for _ in range(srv.quiescence_steps + 2):
            srv.idle_step()
        torch.cuda.synchronize()
        return tracked

    t0 = time.perf_counter()
    try:
        tracked, counts = counted("two-agent merge", drive,
                                  lambda _: server_want(srv, trackers))
    finally:
        stages.restore()
    run_s = time.perf_counter() - t0
    slot = srv.agents[0].map_slot
    shared = srv.agents[1].map_slot == slot and len(srv.maps) == 1
    structure = ms.check_structure(srv.maps[slot])
    ates = merge_ates(srv, seqs)
    ok = (bool(merge) and shared and structure == []
          and all(rmse < gate for rmse, _, gate, _ in ates))
    log(f"  frames tracked: agent 0 {tracked[0]}/{MERGE_FRAMES}, agent 1 {tracked[1]}/"
        f"{MERGE_FRAMES}; merged {bool(merge)} at step {merge.get('step')} on the keyframe pair "
        f"(client, kf id) {merge.get('pair')}; both agents in slot {slot} {shared}; "
        f"check_structure {len(structure)} findings (0)")
    for i, (rmse, span, gate, n) in enumerate(ates):
        log(f"  agent {i}: {n} keyframes, keyframe ATE {rmse:.4f} m over a {span:.3f} m span "
            f"(gate {gate:.4f} m = max(0.02 span + 0.05, 2 x the JAX package's "
            f"{JAX_MERGE_ATE_M[i]:.4f} m))  {'ok' if rmse < gate else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the two-agent merge failed its gates: {structure[:5]}")
    st = srv.stats
    n_chunks = sum(1 for _, _, stats in st["gba"] if not stats)
    log(f"[times] two-agent merge, {smi}: {run_s:.1f} s; per-frame wall (both agents, each "
        f"ending in a sync) median {statistics.median(frame_walls):.3f} ms; {st['ingests']} "
        f"ingests, {len(st['gba'])} GBA calls ({n_chunks} interruptible chunks); loop closures "
        f"attempted {sum(f.stats['sim3_attempts'] for f in srv.finders.values())}, merge "
        f"attempts {srv.matcher.stats['sim3_attempts']}")
    for name, ws in stages.ms.items():
        log(f"  {name}, {smi}: {len(ws)} call(s), median {statistics.median(ws):.3f} ms, "
            f"min {min(ws):.3f}, max {max(ws):.3f}, total {sum(ws):.1f}")
    log(f"  the merging try_match, {smi}: {merge['wall']:.3f} ms")
    for name, iters, wall, busy, off, n_k in gbas:
        log(f"  {name} ({iters} iterations, {smi}): wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms ({busy / wall:.1%}), {off - iters if off else 0} CG steps, "
            f"{n_k} device kernels")
    mm = map_matching.MapMatcher(cfg=cfg, cam=cam, vocab=vocab, n_slots=2,
                                 kf_capacity=merge["kf_capacity"], db=merge["db"],
                                 rng=torch.Generator(device=dev))
    mm.rng.set_state(merge["rng"])
    res, device, wall = profiled(lambda: mm.try_match(*merge["args"]))
    busy = sum(e.self_device_time_total for e in device) / 1e3
    log(f"  the merging step's try_match replayed under the profiler ({smi}): merged again "
        f"{res is not None}, wall {wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.1%}), "
        f"{sum(e.count for e in device)} device kernels, the port's CUDA kernels "
        f"{port_kernels_ms(device):.3f} ms")
    if res is None:
        raise AssertionError("the merging try_match did not merge again on its replay")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.key[:70]:<70} x{e.count} {e.self_device_time_total / 1e3:.3f} ms")
    del srv._run_gba, srv.matcher.try_match  # phase 13's tracing wrappers
    return counts, srv, seqs, last_gba


# ---------------------------------------------------------------------------
# Phase 14: the landmark-sharded GBA (parallel/dist_ba.py) at world size 1
# over NCCL.
# ---------------------------------------------------------------------------


def dist_want(iters, calls, pcg):
    """The launches of ``dist_ba_solve``: per call one cost of the entry
    state; per LM iteration one normal_blocks and one trial cost; on the
    PCG branch also one rhs, one wtv (back-substitution) and one off for the
    initial residual plus one per CG step (at most CG_ITERS; the callers
    hold the CG steps, ``schur_off`` - iters, to ``ba_solve``'s).  The dense
    branch back-substitutes by the reference's gather, as ``ba_solve`` does:
    no wtv."""
    want = dict(reproj_cost=iters + calls, normal_blocks=iters)
    if pcg:
        want.update(schur_rhs=iters, schur_wtv=iters,
                    schur_off=(iters, iters * (CG_ITERS + 1)))
    return want


def cg_steps(counts, iters):
    """CG steps of a solve of ``iters`` LM iterations, from its launches."""
    return counts["schur_off"] - iters if counts["schur_off"] else 0


def sharded_solve(mesh, prob, iters, chunks):
    """``dist_ba_solve`` over ``chunks`` equal chunks carrying the state,
    ending in a sync; returns (R, t, X, cost)."""
    p, state = dist_ba.shard_problem(prob, mesh), None
    for _ in range(chunks):
        R, t, X, cost, state = dist_ba.dist_ba_solve(p, mesh, iters=iters // chunks,
                                                     state=state, return_state=True)
        p = p.replace(R=R, t=t, X=X)
    torch.cuda.synchronize()
    return R, t, dist_ba.gather_points(X, mesh), cost


def wall_ms_per_iter(fn, iters, runs=3):
    """Median wall ms per LM iteration of ``runs`` calls of ``fn``, each
    ending in a sync."""
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(walls)


def check_sharded_gba(mesh, label, arr, smi, iters=12, chunks=3):
    """Phase 14 (a) and (b): the sharded solve in ``chunks`` chunks against
    one monolithic sharded solve (cost within 1e-5 relative) and the port's
    ``ba_solve`` (cost within 5% + 1e-3, camera centres within 5e-3,
    ``dryrun_multichip``'s bounds), converged below 0.05x the initial cost;
    launches held to ``dist_want``, the CG steps of all three equal; wall
    per LM iteration beside ``ba_solve``'s and the sharded solve's device
    busy share.  Returns the chunked solve's launch counts."""
    prob = convert.ba_problem_from_numpy(arr, mesh.device)
    C = prob.R.shape[0]
    pcg = C > ba.pcg_min_c()
    cost0 = float(ba._cost(prob, prob.R, prob.t, prob.X, HUBER))
    out_c, counts = counted(f"{label}: sharded, {chunks} chunks x {iters // chunks}",
                            lambda: sharded_solve(mesh, prob, iters, chunks),
                            dist_want(iters, chunks, pcg))
    out_m, counts_m = counted(f"{label}: sharded, monolithic {iters}",
                              lambda: sharded_solve(mesh, prob, iters, 1),
                              dist_want(iters, 1, pcg))
    single, counts_s = counted(f"{label}: ba_solve {iters}",
                               lambda: ba.ba_solve(prob, iters=iters),
                               solve_launches(iters, pcg=pcg))
    cg = [cg_steps(c, iters) for c in (counts, counts_m, counts_s)]
    cost_c, cost_m, cost_s = float(out_c[3]), float(out_m[3]), float(single[3])
    err = float((centres(out_c[0], out_c[1]) - centres(single[0], single[1]))
                .norm(dim=-1).max())
    rel = abs(cost_c - cost_m) / cost_m
    ok = (np.isfinite(cost_c) and cost_c < 0.05 * cost0
          and abs(cost_c - cost_s) <= 0.05 * cost_s + 1e-3 and err < 5e-3
          and rel <= 1e-5 and cg[0] == cg[1] == cg[2])
    log(f"  {label}: cost {cost0:.3f} -> sharded {cost_c:.4f} ({cost_c / cost0:.5f}x, gate "
        f"0.05x), monolithic {cost_m:.4f} (rel diff {rel:.2e}, tol 1e-5), ba_solve "
        f"{cost_s:.4f} (tol 0.05*cost+1e-3), centre err {err:.2e} (tol 5e-3); CG steps "
        f"{cg[0]} chunked, {cg[1]} monolithic, {cg[2]} ba_solve (equal)  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the sharded GBA failed its gates")
    ms_dist = wall_ms_per_iter(lambda: sharded_solve(mesh, prob, iters, 1), iters)
    ms_single = wall_ms_per_iter(lambda: ba.ba_solve(prob, iters=iters), iters)
    _, device, wall = profiled(lambda: sharded_solve(mesh, prob, iters, 1))
    busy = sum(e.self_device_time_total for e in device) / 1e3
    log(f"[times] {label}, {smi}: wall per LM iteration (median of 3 solves of {iters}) "
        f"sharded {ms_dist:.3f} ms, ba_solve {ms_single:.3f} ms; the sharded solve under "
        f"the profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.1%}), "
        f"{sum(e.count for e in device)} device kernels, the port's CUDA kernels "
        f"{port_kernels_ms(device):.3f} ms")
    return counts


def collective_timings(mesh, smi, C=256, reps=200):
    """Wall us of one rank-order sum of a [C,6] camera vector (what each CG
    step of the sharded PCG adds), of its all-gather alone and, as a
    yardstick the port does not use, of one all-reduce: medians of ``reps``
    calls after 20 warm-up calls, each ending in a sync."""
    v = torch.ones(C, 6, device=mesh.device)
    for name, fn in (("sum_ranks", lambda: dist_ba.sum_ranks(v, mesh)),
                     ("all-gather alone", lambda: dist_ba._all_gather(v, mesh)),
                     ("all-reduce (yardstick)",
                      lambda: torch.distributed.all_reduce(v, group=mesh.group))):
        for _ in range(20):
            fn()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6)
        log(f"[times] {name} of a [{C},6] vector over {mesh.backend} (world size "
            f"{mesh.world_size}), {smi}: median {statistics.median(walls):.1f} us, min "
            f"{min(walls):.1f} us ({reps} calls, each ending in a sync)")


def check_merged_resolve(srv, last_gba, seqs, mesh, smi):
    """Phase 14 (c): phase 13's final GBA of the merged slot solved again
    from the map it started from, unsharded and then with ``srv.mesh`` set
    (20 iterations each): the sharded cost below the entry cost (a GBA of no
    iteration), within 5% + 1e-3 of the unsharded one, the same CG steps,
    and phase 13's ATE gates on the sharded result.  Returns the sharded
    solve's launch counts."""
    slot = srv.agents[0].map_slot
    m_entry, m_exit = last_gba[slot]
    if srv.maps[slot] is not m_exit:
        raise AssertionError("the merged slot changed after its final GBA")
    C = m_entry.kfs.capacity
    pcg = C > ba.pcg_min_c()
    iters = srv.gba_total_iters
    srv.maps[slot] = m_entry
    cost_in = srv._run_gba(slot, 0)
    srv.maps[slot] = m_entry
    t0 = time.perf_counter()
    cost_u, counts_u = counted("merged slot, unsharded GBA", lambda: srv._run_gba(slot, iters),
                               solve_launches(iters, pcg=pcg))
    wall_u = (time.perf_counter() - t0) * 1e3
    same = bool(torch.equal(srv.maps[slot].kfs.t_cw, m_exit.kfs.t_cw)
                and torch.equal(srv.maps[slot].mps.pos, m_exit.mps.pos))
    srv.maps[slot] = m_entry
    srv.mesh = mesh
    t0 = time.perf_counter()
    cost_s, counts = counted("merged slot, sharded GBA", lambda: srv._run_gba(slot, iters),
                             dist_want(iters, 1, pcg))
    wall_s = (time.perf_counter() - t0) * 1e3
    cg_u, cg_s = cg_steps(counts_u, iters), cg_steps(counts, iters)
    ates = merge_ates(srv, seqs)
    ok = (cost_s < cost_in and abs(cost_s - cost_u) <= 0.05 * cost_u + 1e-3 and cg_s == cg_u
          and all(rmse < gate for rmse, _, gate, _ in ates))
    log(f"  merged slot ({C} keyframe slots, P={m_entry.mps.capacity}, "
        f"{'PCG' if pcg else 'dense'}) from phase 13's final-GBA entry map, {iters} "
        f"iterations: entry cost {cost_in:.4f}; unsharded {cost_u:.4f} "
        f"({cost_u / cost_in:.5f}x; the map phase 13's final GBA left: {same}), sharded "
        f"{cost_s:.4f} ({cost_s / cost_in:.5f}x, gate < 1x and within 0.05*cost+1e-3 of "
        f"unsharded); CG steps {cg_s} sharded, {cg_u} "
        f"unsharded (equal); wall {wall_u:.3f} ms unsharded, {wall_s:.3f} ms sharded ({smi})  "
        f"{'ok' if ok else 'FAIL'}")
    for i, (rmse, span, gate, n) in enumerate(ates):
        log(f"  agent {i} after the sharded GBA: {n} keyframes, keyframe ATE {rmse:.4f} m over "
            f"{span:.3f} m (gate {gate:.4f} m)  {'ok' if rmse < gate else 'FAIL'}")
    srv.mesh = None
    if not ok:
        raise AssertionError("the merged slot's sharded GBA failed its gates")
    return counts


# ---------------------------------------------------------------------------
# Phase 15: the entry points a user types -- the runner and the deployment.
# ---------------------------------------------------------------------------

RUN_ARGV = ["--dataset", "rendered", "--seq", "corridor:0:60:0-0.08", "--factor", "1.0",
            "--server", "--trim", "--vicinity", "6", "--progress", "20"]
RUN_VOCAB_ITERS = 6   # the runner's vocabulary bootstrap (no --vocab)
DEPLOY_VOCAB_ITERS = 6  # the deployment server's vocabulary (``deploy._vocab``)
DEPLOY_TIMEOUT_S = 300
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def runner_want(state):
    """The kernel launches of a runner call with the server, from what it
    counted: ``server_want`` of its server and trackers, and one
    hamming_top2 per iteration of the vocabulary bootstrap."""
    want = server_want(state["server"], state["trackers"])
    lo, hi = want.get("hamming_top2", (0, 0))
    want["hamming_top2"] = (lo + RUN_VOCAB_ITERS, hi + RUN_VOCAB_ITERS)
    return want


def check_runner(smi, client_median_ms):
    """Phase 15 (a): ``run.main`` in this process on cuda:0, counted; gated
    on its exit code, its files and its printed keyframe ATE.  Returns the
    counts."""
    out = OUT_DIR / "run"
    state, printed = {}, io.StringIO()

    def drive():
        with contextlib.redirect_stdout(printed):
            return run.main(RUN_ARGV + ["--out", str(out)], state)

    t0 = time.perf_counter()
    rc, counts = counted("runner", drive, lambda _: runner_want(state))
    run_s = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    for line in lines:
        if line.startswith("[agent") or line.startswith("agent"):
            log(f"  | {line}")
    srv, seq = state["server"], state["seqs"][0]
    ts, R, t = srv.trajectory(0)
    want = OUT_DIR / "run_want_KF_GBA_0.csv"
    write_tum(str(want), ts, R, t, t_sc=np.asarray(state["cfg"].camera.t_sc))
    same_traj = (out / "KF_GBA_0.csv").read_text() == want.read_text()
    m = checkpoint.load_map(str(out / "map_0.npz"), "cuda:0")
    structure = ms.check_structure(m)
    ply = (out / "map_0.ply").read_text().splitlines()
    n_ply = int(next(x for x in ply if x.startswith("element vertex")).split()[-1])
    scene = json.loads((out / "scene_0.json").read_text())
    ate_lines = [x for x in lines if x.startswith("agent 0: ATE RMSE (Sim3) = ")]
    rmse = float(ate_lines[0].split("= ")[1].split()[0]) if ate_lines else float("inf")
    gt_ts, gt_pos, _ = seq.ground_truth()
    gt = gt_pos[np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)]
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    gate = 0.02 * span + 0.05
    n_alive = int((m.kfs.valid & ~m.kfs.bad).sum())
    ok = (rc == 0 and same_traj and structure == [] and len(ply) == n_ply + 10
          and scene["n_keyframes"] == n_alive and rmse < gate and len(ts) >= 3)
    log(f"  exit {rc}; KF_GBA_0.csv {len(ts)} keyframes, the server's trajectory as write_tum "
        f"writes it {same_traj}; map_0.npz loads, check_structure {len(structure)} findings "
        f"(0); map_0.ply {n_ply} points, scene_0.json {scene['n_keyframes']} keyframes "
        f"({n_alive} alive); keyframe ATE {rmse:.4f} m over a {span:.3f} m span (gate "
        f"{gate:.4f} m = 0.02 span + 0.05: no JAX figure of this run)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the runner failed its gates: {structure[:5]}")
    walls = [w * 1e3 for w in state["frame_walls"]]
    log(f"[times] runner, {smi}: {run_s:.1f} s for {len(walls)} frames; per-frame wall (tracking "
        f"only, CUDA events around each frame, no sync) median {statistics.median(walls):.3f} ms, min "
        f"{min(walls):.3f}, max {max(walls):.3f}; phase 11's median {client_median_ms:.3f} ms; "
        f"{srv.stats['ingests']} ingests, {len(srv.stats['gba'])} GBA calls")
    return counts


def deploy_events(text):
    out = []
    for line in text.splitlines():
        try:
            e = json.loads(line)
        except ValueError:
            continue
        if isinstance(e, dict):
            out.append(e)
    return out


def deploy_launches(label, summary, done):
    """Hold each deployment process's kernel launches (counted from 0 at its
    start, reported in its closing event) to what its reported work implies:
    the server's ``server_work_want`` plus its vocabulary's training
    iterations, a sequence client's ``client_want``, a synthetic client none.
    Returns their sum over the processes."""
    want = server_work_want(summary["work"])
    add_want(want, {"hamming_top2": DEPLOY_VOCAB_ITERS})
    hold_counts(f"{label}, the server process", summary["launches"], want)
    total = dict(summary["launches"])
    for d in done:
        hold_counts(f"{label}, client {d['agent']}'s process", d["launches"],
                    client_want(d["work"]) if "work" in d else {})
        for name, n in d["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def check_deploy_launch(smi):
    """Phase 15 (b), first part: ``deploy launch --agents 2`` (synthetic
    profile, the server and both clients on cuda:0), gated as
    tests/test_multiprocess.py::test_two_agent_deployment, with each
    process's launches held to its work.  Returns their sum."""
    out = OUT_DIR / "mp"
    cmd, env = deploy.module_command("launch", "--agents", 2, "--out", out, "--timeout",
                                     DEPLOY_TIMEOUT_S - 60)
    t0 = time.perf_counter()
    # its own session: on a timeout the launcher and the processes it started
    # go together
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=DEPLOY_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    ev = deploy_events(stdout)
    for e in ev:
        log(f"  | {json.dumps(e)}")
    summary = next((e for e in ev if e.get("event") == "run_summary"), {})
    done = [e for e in ev if e.get("event") == "client_done"]
    shapes, close = [], False
    if proc.returncode == 0 and summary:
        t = [np.loadtxt(out / f"KF_GBA_{a}.csv") for a in (0, 1)]
        shapes = [x.shape for x in t]
        if shapes == [(4, 8), (4, 8)]:
            t0_, t1_ = t[0][:, 1:4], t[1][:, 1:4]
            step = np.linalg.norm(t0_[1] - t0_[0])
            close = bool(np.linalg.norm(t0_[2] - t1_[2]) < 0.2 * step
                         and np.linalg.norm(t0_[3] - t1_[1]) < 0.2 * step)
    ok = (proc.returncode == 0 and summary.get("merges", 0) >= 1
          and summary.get("agents_share_map") is True and len(done) == 2
          and all(d["kfs_acked"] == 4 for d in done) and shapes == [(4, 8), (4, 8)] and close)
    log(f"  exit {proc.returncode}; merges {summary.get('merges')} (>= 1), agents share a map "
        f"{summary.get('agents_share_map')}, keyframes acked {[d['kfs_acked'] for d in done]} "
        f"(4 each), TUM files {shapes}, co-located keyframes within 0.2 of a corridor step "
        f"{close}  {'ok' if ok else 'FAIL'}")
    log(f"[times] deploy launch --agents 2 (3 processes on the card, beside the sequence "
        f"deployment), {smi}: {wall:.1f} s of wall")
    if not ok:
        raise AssertionError(f"the two-agent deployment failed its gates:\n{stdout}\n"
                             f"{stderr[-4000:]}")
    return deploy_launches("deploy launch", summary, done)


def check_sequence_client(smi):
    """Phase 15 (b), second part: a server (``--profile rendered --factor
    1.0 --vicinity 6``) and a sequence-streaming client over 60 rendered
    corridor frames at 752x480, both on cuda:0; gated as
    tests/test_multiprocess.py::test_sequence_streaming_client, with each
    process's launches held to its work.  Returns their sum."""
    port = deploy.free_port()
    common = ["--profile", "rendered", "--factor", "1.0", "--timeout", DEPLOY_TIMEOUT_S - 60]
    srv_cmd, env = deploy.module_command(
        "server", "--port", port, "--agents", 1, "--out", OUT_DIR / "mp_seq", "--quiescence", 5,
        "--vicinity", 6, *common)
    cli_cmd, _ = deploy.module_command(
        "client", "--agent", 0, "--connect", f"127.0.0.1:{port}", "--seq",
        "rendered:corridor:0:60:0-0.07", "--kf-budget", 40, "--mp-budget", 2500, *common)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, start_new_session=True) for c in (srv_cmd, cli_cmd)]
    try:
        cli_out, _ = procs[1].communicate(timeout=DEPLOY_TIMEOUT_S)
        srv_out, _ = procs[0].communicate(timeout=DEPLOY_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    wall = time.perf_counter() - t0
    for e in deploy_events(srv_out) + deploy_events(cli_out):
        log(f"  | {json.dumps(e)}")
    done = next((e for e in deploy_events(cli_out) if e.get("event") == "client_done"), {})
    summary = next((e for e in deploy_events(srv_out) if e.get("event") == "run_summary"), {})
    n_kfs = summary.get("trajectories", {}).get("0", {}).get("n_kfs", 0)
    ok = (procs[0].returncode == 0 and procs[1].returncode == 0
          and done.get("mode") == "sequence" and done.get("frames") == 60
          and done.get("publishes", 0) >= 3 and done.get("kfs", 0) >= 4 and n_kfs >= 4)
    log(f"  exit server {procs[0].returncode}, client {procs[1].returncode}; client frames "
        f"{done.get('frames')} (60), publishes {done.get('publishes')} (>= 3), keyframes "
        f"{done.get('kfs')} (>= 4), resets {done.get('resets')}; the server's trajectory "
        f"{n_kfs} keyframes (>= 4)  {'ok' if ok else 'FAIL'}")
    log(f"[times] server + sequence client (2 processes on the card, 60 frames at 752x480, "
        f"beside the two-agent deployment), {smi}: {wall:.1f} s of wall")
    if not ok:
        raise AssertionError(f"the sequence-streaming deployment failed its gates:\n"
                             f"{srv_out[-4000:]}\n{cli_out[-4000:]}")
    return deploy_launches("sequence deployment", summary, [done])


# ---------------------------------------------------------------------------
# Phase 16: the vocabulary trainer at full width.
# ---------------------------------------------------------------------------

TRAIN_BLOCK = 8192           # bow.train_vocabulary_large: descriptors per nearest-word call
RECALL_SEEDS = (10, 11)      # tests/test_vocab_recall.py: world seeds the trainer never saw
RECALL_FRAMES = 48
RECALL_FEATURES = 800
RECALL_FACTOR = 0.5


def train_vocab_want(state):
    """One hamming_top2 per training iteration per block of TRAIN_BLOCK
    descriptors (of those left after ``subsample``)."""
    return {"hamming_top2": train_vocab.ITERS * -(-state["n_train"] // TRAIN_BLOCK)}


def recall_figures(vecs):
    """tests/test_vocab_recall.py's figures from BoW vectors {(world, seed):
    [frames, W]}, the even frames a database and the odd ones queries:
    (same-place hits, queries, the cross-world margins)."""
    keys = list(vecs)
    scores = {(a, b): bow.l1_score(vecs[a][1::2][:, None], vecs[b][0::2][None]).cpu().numpy()
              for a in keys for b in keys}
    hits = total = 0
    margins = []
    for a in keys:
        own = scores[(a, a)]
        for j, row in enumerate(own):
            hits += int(np.argmax(row)) in (j, j + 1)  # the even frames flanking query j
            total += 1
        for b in keys:
            if b != a:
                for j, row in enumerate(scores[(a, b)]):
                    own_hit = max(own[j, j], own[j, min(j + 1, own.shape[1] - 1)])
                    margins.append(own_hit - row.max())
    return hits, total, np.array(margins)


def check_recall(label, vocab, feats):
    """Every held-out frame through ``bow.transform`` (one hamming_top2
    each), then tests/test_vocab_recall.py's three gates: same-place recall
    >= 0.9 over >= 20 queries, a positive cross-world margin in >= 90% of
    cases with median > 0.01, more than 30,000 distinct words.  Logs the
    figures; returns whether every gate held."""
    vecs = {key: torch.stack([bow.transform(vocab, f.desc, f.valid)[0] for f in fs])
            for key, fs in feats.items()}
    hits, total, margins = recall_figures(vecs)
    distinct = int(torch.unique(vocab.words, dim=0).shape[0])
    positive, median = float((margins > 0).mean()), float(np.median(margins))
    ok = (tuple(vocab.words.shape) == (32768, 32) and total >= 20 and hits / total >= 0.9
          and positive >= 0.9 and median > 0.01 and distinct > 30000)
    log(f"  {label}: same-place recall {hits}/{total} = {hits / total:.4f} (>= 0.9 over >= 20); "
        f"cross-world margin > 0 in {positive:.4f} of {len(margins)} (>= 0.9), median "
        f"{median:.6f} (> 0.01); {distinct} distinct words (> 30000)  {'ok' if ok else 'FAIL'}")
    return ok


def check_train_vocab(dev, smi, block_ms):
    """Phase 16: ``train_vocab.main`` in this process on cuda:0 at the
    reference's settings, into a temporary file, counted; then
    tests/test_vocab_recall.py's protocol and gates on the held-out seeds,
    for the trained codebook and the port's checked-in vocab32k on the same
    frames, counted (one hamming_top2 per frame and codebook).  ``block_ms``
    is phase 4's device time of one training block.  Returns the two
    parts' counts summed."""
    state, printed = {}, io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "vocab32k.npz"

        def drive():
            with contextlib.redirect_stdout(printed):
                return train_vocab.main(["--out", out], state)

        t0 = time.perf_counter()
        rc, counts = counted("train_vocab.main", drive, lambda _: train_vocab_want(state))
        main_s = time.perf_counter() - t0
        for line in printed.getvalue().splitlines():
            log(f"  | {line}")
        trained = bow.load_vocabulary(str(out), dev)
        size = out.stat().st_size
    n, n_train = state["n_descs"], state["n_train"]
    same = (torch.equal(trained.words, state["vocab"].words)
            and torch.equal(trained.idf, state["vocab"].idf))
    ok = (rc == 0 and same and n_train == min(n, train_vocab.LIMIT) > 0
          and trained.n_words == train_vocab.N_WORDS)
    n_seq = len(train_vocab.WORLDS) * len(train_vocab.SEEDS)
    cam = config.scaled_camera(factor=train_vocab.FACTOR)
    log(f"  exit {rc}; {n} descriptors from {n_seq} sequences x {train_vocab.N_PER_SEQ} frames "
        f"({cam.width}x{cam.height}, {train_vocab.N_FEAT} features), {n_train} trained on; "
        f"the saved file "
        f"({size} bytes) reads back as the trained codebook {same}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the vocabulary trainer failed its checks")
    n_top2 = counts["hamming_top2"]
    log(f"[times] train_vocab, {smi}: collection {state['collect_s']:.3f} s (raycast and "
        f"orb.extract on the card, {n_seq * train_vocab.N_PER_SEQ} frames), training "
        f"{state['train_s']:.3f} s ({train_vocab.ITERS} iterations, {n_top2} hamming_top2 "
        f"launches: about {n_top2 * block_ms:.3f} ms of device time at phase 4's "
        f"{block_ms:.4f} ms a block), main {main_s:.3f} s of wall (CUDA events with a sync at "
        f"each end for collection and training)")

    t0 = time.perf_counter()
    feats = {(world, seed): train_vocab.sequence_features(
        world, seed, RECALL_FRAMES, RECALL_FEATURES, RECALL_FACTOR, dev)
        for seed in RECALL_SEEDS for world in ("corridor", "loop")}
    torch.cuda.synchronize()
    n_frames = sum(len(f) for f in feats.values())
    cam = config.scaled_camera(factor=RECALL_FACTOR)
    log(f"  held-out frames: seeds {RECALL_SEEDS}, corridor and loop, {n_frames} frames at "
        f"{cam.width}x{cam.height}, {RECALL_FEATURES} features, in "
        f"{time.perf_counter() - t0:.1f} s")
    books = {"trained": trained, "checked-in vocab32k": bow.load_vocabulary(None, dev)}
    t0 = time.perf_counter()
    passed, recall = counted(
        "recall transforms", lambda: {name: check_recall(name, v, feats)
                                      for name, v in books.items()},
        {"hamming_top2": len(books) * n_frames})
    log(f"[times] recall, {smi}: {time.perf_counter() - t0:.1f} s for {len(books)} codebooks x "
        f"{n_frames} frames")
    failed = [name for name, ok in passed.items() if not ok]
    if failed:
        raise AssertionError(f"{failed}: failed tests/test_vocab_recall.py's gates")
    return {name: counts.get(name, 0) + recall.get(name, 0) for name in counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()

    # -- phase 1: device and build ---------------------------------------
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    probe = mma_b1_rate.start_build()  # one nvcc each, all in parallel
    libs = _build.build_all(["ba_kernels", "hamming_kernels"])
    logs = {**{name: _build.build_log(name) for name in libs},
            "mma_b1_rate": mma_b1_rate.finish_build(probe)}
    log(f"[build] {', '.join(p.name for p in libs.values())}, "
        f"{mma_b1_rate.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {line.strip()}")
    rate = mma_b1_rate.measure(dev)
    log(f"[build] 1-bit MMA (m16n8k256 and.popc): fragment mapping checked against host "
        f"popcounts {'ok' if rate['tile_ok'] else 'FAIL'}; {rate['mma_per_s']:.4e} "
        f"instructions/s, {rate['pairs_per_s']:.4e} pairs/s, "
        f"{rate['mma_per_clk_per_sm']:.4f} per clock per SM at {rate['max_sm_clock_mhz']:g} MHz")
    if not rate["tile_ok"]:
        raise AssertionError("the 1-bit MMA tile disagrees with popcounts on the host")
    phase_done(1)

    # -- phase 2: kernels against their plain versions ---------------------
    rng = np.random.default_rng(0)
    bench = problems.make_problem(device=dev)
    errs, inputs = check_kernels(bench, rng, "bench shapes")
    check_kernels(convert.ba_problem_from_numpy(problems.ragged_problem_arrays(), dev),
                  rng, "ragged")
    # the client's local-BA widths: C=40 cameras, P=4096 landmarks, K=16
    # (rendered_ci_config) and K=32 (the default max_obs_per_mp) slots, and
    # a ragged K=12 case (fixed cameras, invalid points, ids out of range)
    local_inputs = {}
    for K in (16, 32):
        local_inputs[K] = check_kernels(problems.make_problem(C=40, P=4096, K=K, device=dev),
                                        rng, f"local BA K={K}")[1]
    ragged12 = problems.small_ba_problem_arrays(P=3001, K=12, C=37, seed=12, fixed=5)
    ragged12["cam_idx"][~ragged12["obs_valid"]] = -1  # local BA's padding, on camera 0
    ragged12["cam_idx"][:4, 0] = [-1, 37, 40, -3]
    check_kernels(convert.ba_problem_from_numpy(ragged12, dev), rng, "ragged K=12")
    # the initialization BA: 160 keyframe slots, two of them live; every empty
    # slot of the 24,576 x 16 landmark arena on camera 0
    init_inputs = check_kernels(
        convert.ba_problem_from_numpy(problems.init_ba_problem_arrays(), dev), rng,
        "initialization BA")[1]
    Cr = 37
    v = torch.as_tensor(rng.standard_normal((Cr, 5)).astype(np.float32), device=dev)
    ci = torch.as_tensor(rng.integers(-3, Cr + 3, 999).astype(np.int32), device=dev)
    compare("cam_broadcast.oob", bk.cam_broadcast(v, ci), bk.cam_broadcast_plain(v, ci),
            0.0, 0.0)
    log("[kernels] all kernels agree with their plain versions")
    phase_done(2)

    # -- phase 3: the slice, through the entry points, counted per path ----
    def start_cost(prob):
        return float(ba._cost(prob, prob.R, prob.t, prob.X, HUBER))

    log("[slice] ba_solve, server GBA (PCG branch)")
    cost0 = start_cost(bench)
    _, gba = counted("server GBA", lambda: check_solve(
        "C=128 P=32768 K=8 iters=20", bench, 20, cost0), solve_launches(20, pcg=True))

    log("[slice] ba_solve, local BA (dense branch)")
    local = problems.make_problem(C=70, P=4096, K=8, device=dev)
    local_cost0 = start_cost(local)
    counted("local BA", lambda: check_solve(
        "C=70 P=4096 K=8 iters=20", local, 20, local_cost0), solve_launches(20, pcg=False))
    for K in (16, 32):
        wide = problems.make_problem(C=40, P=4096, K=K, device=dev)
        wide_cost0 = start_cost(wide)
        counted(f"local BA K={K}", lambda: check_solve(
            f"C=40 P=4096 K={K} iters=15", wide, 15, wide_cost0), solve_launches(15, pcg=False))

    log("[slice] interrupted GBA: 3 chunks x 4 iterations against 12 at once")
    (_, _, _, cost_mono, _), mono = counted(
        "monolithic 12 iterations", lambda: ba.ba_solve(bench, iters=12),
        solve_launches(12, pcg=True))

    def chunked():
        prob, state = bench, None
        for _ in range(3):
            R, t, X, cost, _, state = ba.ba_solve(
                prob, iters=4, state=state, return_state=True, with_stats=False)
            prob = prob.replace(R=R, t=t, X=X)
        return cost

    cost_chunk, chunk = counted("3 chunks x 4 iterations", chunked,
                                solve_launches(12, pcg=True, calls=3, stats=False))
    cost_mono, cost_chunk = float(cost_mono), float(cost_chunk)
    rel = abs(cost_chunk - cost_mono) / cost_mono
    same_cg = chunk["schur_off"] == mono["schur_off"]
    ok = rel <= 1e-2 and same_cg
    log(f"  chunked {cost_chunk:.4f} monolithic {cost_mono:.4f} rel diff {rel:.2e} "
        f"(tol 1e-2); CG steps {chunk['schur_off'] - 12} and {mono['schur_off'] - 12}"
        f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("chunked and monolithic solves took different paths")

    log("[slice] optimize_pose N=512 (no kernel on this path)")
    trk = problems.tracking_arrays(512)
    fx, fy, cx, cy = problems.INTRINSICS

    def track(d):
        return pose_opt.optimize_pose(*[torch.as_tensor(a, device=d) for a in trk.values()],
                                      fx, fy, cx, cy)

    (Rg, tg, inl_g, n_g), _ = counted("optimize_pose", lambda: track(dev), {})
    Rc, tc, inl_c, n_c = track(torch.device("cpu"))
    err_R = float((Rg.cpu() - Rc).abs().max())
    err_t = float((tg.cpu() - tc).abs().max())
    ok = err_R < 1e-4 and err_t < 1e-3 and int(n_g) == int(n_c) and float(tg.norm()) < 0.05
    log(f"  card vs cpu: |dR| {err_R:.2e} |dt| {err_t:.2e}, inliers {int(n_g)}/{int(n_c)}, "
        f"|t| {float(tg.norm()):.4f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("optimize_pose on the card disagrees with the CPU")

    log("[slice] card against CPU on small problems")
    agree_with_cpu("dense C=40 P=700 K=4", problems.small_ba_problem_arrays(), 20)
    agree_with_cpu("pcg C=100 P=1024 K=4",
                   problems.arc_problem_arrays(C=100, P=1024, K=4), 20)
    agree_with_cpu("dense C=40 P=700 K=16",
                   problems.small_ba_problem_arrays(P=700, K=16, C=40), 15)
    phase_done(3)

    # -- phase 4: times ------------------------------------------------------
    log(f"[times] kernels at bench shapes; {smi}")
    times = kernel_timings(inputs)
    log(f"[times] normal_blocks, cam_reduce and reproj_cost at the client's local-BA shape; "
        f"{smi}")
    local = local_inputs[16]
    time_table({"normal_blocks": blocks_entry(bk, local["prob"], local["csr"]),
                "cam_reduce": reduce_entry(bk, local["prob"]),
                "reproj_cost": cost_entry(bk, local["prob"]),
                "cam_broadcast F=12": broadcast_entry(bk, local["prob"], 12)},
               4096 * 16, "local BA")
    log(f"[times] reproj_cost, the Schur operators and normal_blocks at the initialization "
        f"BA's shape; {smi}")
    init = init_inputs["prob"]
    time_table({"reproj_cost": cost_entry(bk, init),
                **schur_entries(init, *(init_inputs[k] for k in ("W", "Vinv", "v", "q"))),
                "normal_blocks": blocks_entry(bk, init, init_inputs["csr"]),
                "cam_broadcast F=12": broadcast_entry(bk, init, 12)},
               init.cam_idx.numel(), "init BA")
    del init, init_inputs
    # every kernel is timed before the first long profiler window (the solve
    # below): windows after one have lost a few device events
    stress = convert.ba_problem_from_numpy(problems.stress_problem_arrays(), dev)
    log(f"[times] normal_blocks, cam_reduce, reproj_cost, make_schur_matvec, rhs, wtv and "
        f"cam_broadcast at the stress shape; {smi}")
    new_times = stress_timings(stress, rng)
    log(f"[times] hamming_top2 (relocalization against phase 7's arena, 24,576-slot arenas, "
        f"keyframe pairs, a keyframe's BoW transform and an ingest's BoW batch against "
        f"vocab32k: every word valid; a training block of the vocabulary trainer); {smi}")
    top2_times = {f"{Q}x{Tn}": top2_timing(hk, top2_inputs(Q, Tn, dev), rate, f"{Q} x {Tn}")
                  for Q, Tn in ((1024, 16384), (1024, 24576), (1024, 1024))}
    q, qv, t, tv = top2_inputs(1024, 32768, dev)
    top2_times["1024x32768"] = top2_timing(hk, (q, qv, t, torch.ones_like(tv)), rate,
                                           "1024 x 32768 (vocab32k)")
    top2_times["81920x32768"] = top2_timing(
        hk, ingest_top2_inputs(dev), rate, "(80 x 1024) x 32768 (an ingest's BoW batch)",
        plain=lambda *a: top2_plain_rows(hk, *a))
    q, qv, t, tv = top2_inputs(TRAIN_BLOCK, 32768, dev)
    top2_times["8192x32768"] = top2_timing(
        hk, (q, torch.ones_like(qv), t, torch.ones_like(tv)), rate,
        f"{TRAIN_BLOCK} x 32768 (a training block of the vocabulary trainer, all valid)",
        plain=lambda *a: top2_plain_rows(hk, *a))
    walls = time_solve(bench, 20, 5)
    wall = statistics.median(walls)
    port_ms = sum(gba[name] * times[name]["ms"] for name in times)
    log(f"[times] ba_solve C=128 P=32768 K=8, 20 iterations, 5 runs: "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; median {wall * 1e3:.2f} ms, "
        f"{wall / 20 * 1e3:.3f} ms per LM iteration ({20 / wall:.1f} iters/s); the port's "
        f"kernels {port_ms:.2f} ms of it by device time ({gba['schur_off'] - 20} CG "
        f"steps, one host sync each)")
    profile_solve(bench)
    phase_done(4)

    # -- phase 5: hamming_top2 against its plain version --------------------
    log("[kernels] hamming_top2 against its plain version")
    hamming_err = check_hamming(dev)
    phase_done(5)

    # -- phase 6: the client bootstrap at 752x480 ----------------------------
    t0 = time.perf_counter()
    seq = RenderedSequence(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22),
                           cam=config.CameraConfig())
    images = RenderedFrames(seq)
    for i in (*INIT_PAIR, RELOC_FRAME):
        images[i]
    log(f"[front-end] rendered frames {sorted(images)} at 752x480 in "
        f"{time.perf_counter() - t0:.1f} s")
    log("[front-end] bootstrap: extract -> build_frame -> search_for_initialization -> "
        "initialize_two_view (no kernel on this path)")
    fe, frames, m_idx, m_ok, out = check_bootstrap(seq, images, dev)
    phase_done(6)

    # -- phase 7: relocalization through the Tracker --------------------------
    log("[front-end] relocalization: Tracker (LOST) -> match_brute (hamming_top2) -> "
        "ransac_pnp -> refine -> local-map gate")
    reloc_tr, reloc_frame, reloc = check_relocalization(fe, seq, images, dev)
    phase_done(7)

    # -- phase 8: front-end times ----------------------------------------------
    log(f"[times] front-end at 752x480; {smi}")
    front_end_timings(fe, frames, m_idx, m_ok, reloc_tr, reloc_frame)
    phase_done(8)

    # -- phase 9: cam_reduce, make_schur_matvec and reproj_cost against plain --
    log("[kernels] cam_reduce, make_schur_matvec, rhs, wtv, reproj_cost and cam_broadcast F=6 "
        "against their plain versions")
    reduce_err = check_cam_reduce(dev)
    matvec_err = check_schur_matvec({"server GBA C=128 P=32768 K=8": bench,
                                     "stress C=1024 P=131072 K=8": stress}, rng)
    stress_cost = bk.reproj_cost(*problem_args(stress), stress.intr.contiguous(), HUBER)
    compare_cost("reproj_cost stress", stress_cost,
                 bk.reproj_cost_plain(*problem_args(stress), stress.intr.contiguous(), HUBER))
    if not torch.equal(stress_cost, bk.reproj_cost(*problem_args(stress),
                                                   stress.intr.contiguous(), HUBER)):
        raise AssertionError("reproj_cost stress: rerun not bit-identical")
    # profile_gba's broadcast of a CG vector (F=6) to the stress observations
    ci6 = stress.cam_idx.reshape(-1).clamp(0, stress.R.shape[0] - 1).contiguous()
    v6 = torch.as_tensor(rng.standard_normal((stress.R.shape[0], 6)).astype(np.float32),
                         device=dev)
    out6 = bk.cam_broadcast(v6, ci6)
    compare("cam_broadcast F=6 stress", out6, bk.cam_broadcast_plain(v6, ci6), 0.0, 0.0)
    if not torch.equal(out6, bk.cam_broadcast(v6, ci6)):
        raise AssertionError("cam_broadcast F=6 stress: rerun not bit-identical")
    phase_done(9)

    # -- phase 10: the GBA profiling path ---------------------------------------
    log(f"[gba-profile] profile_gba at the stress shape (C=1024, P=131072, K=8); {smi}")
    prof_counts = check_profile(stress)
    del stress
    torch.cuda.empty_cache()
    phase_done(10)

    # -- phase 11: the client loop at full width --------------------------------
    log("[client] Tracker.process_image over the rendered corridor at 752x480, "
        "rendered_ci_config(1.0)")
    _, client_median_ms = check_client_loop(dev, smi)
    phase_done(11)

    # -- phase 12: the single-agent loop at full width ---------------------------
    log("[loop] StandaloneSystem.process_image over the rendered loop circuit at 752x480, "
        "rendered_ci_config(1.0), 1,024 words, then run_gba(40)")
    loop_counts = check_standalone_loop(dev, smi)
    log(f"  phase-12 launches: {json.dumps(loop_counts)}")
    phase_done(12)

    # -- phase 13: two agents merge on the server ---------------------------------
    log("[server] two rendered agents at 752x480 (rendered_ci_config(1.0), vocab32k) -> "
        "publish -> wire -> Server.ingest / mapping_step / idle_step -> merge -> GBA")
    merge_counts, merge_srv, merge_seqs, merge_gbas = check_two_agent_merge(dev, smi)
    log(f"  phase-13 launches: {json.dumps(merge_counts)}")
    phase_done(13)

    # -- phase 14: the landmark-sharded GBA, world size 1 over NCCL -------------
    mesh = dist_ba.make_mesh(dev)
    log(f"[sharded] dist_ba_solve on a {mesh.backend} group of {mesh.world_size} "
        f"({mesh.device}); the problems of __graft_entry__.dryrun_multichip and "
        f"scripts/dist_worker.py, then phase 13's merged slot")
    dist_counts = {}

    def add_counts(counts):
        for name, n in counts.items():
            dist_counts[name] = dist_counts.get(name, 0) + n

    add_counts(check_sharded_gba(mesh, "dryrun_multichip C=256 P=32768 K=4 (PCG)",
                                 problems.arc_problem_arrays(C=256, P=32768, K=4), smi))
    add_counts(check_sharded_gba(mesh, "dist_worker C=64 P=4096 K=4 (dense)",
                                 problems.arc_problem_arrays(C=64, P=4096, K=4), smi))
    add_counts(check_merged_resolve(merge_srv, merge_gbas, merge_seqs, mesh, smi))
    collective_timings(mesh, smi)
    log(f"  phase-14 launches (the chunked solves and the merged slot's): "
        f"{json.dumps(dist_counts)}")
    torch.distributed.destroy_process_group()
    phase_done(14)

    # -- phase 15: the runner and the deployment through their entry points -----
    log("[entry] python -m ccm_slam_tpu_torch.run " + " ".join(RUN_ARGV) + " (in-process "
        "run.main on cuda:0)")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    runner_counts = check_runner(smi, client_median_ms)
    log(f"  phase-15 (a) launches: {json.dumps(runner_counts)}")
    log("[entry] side by side: python -m ccm_slam_tpu_torch.deploy launch --agents 2 "
        "(synthetic), and deploy server --profile rendered --factor 1.0 --vicinity 6 + client "
        "--seq rendered:corridor:0:60:0-0.07; every process on cuda:0")
    native._build("native_channel")  # once, before the processes need it
    deploy_counts = {}
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(check_deploy_launch, smi),
                    pool.submit(check_sequence_client, smi)]:
            for name, n in fut.result().items():
                deploy_counts[name] = deploy_counts.get(name, 0) + n
    # the deployment's processes went through every kernel the runner did
    unused = [name for name, n in runner_counts.items() if n and not deploy_counts.get(name)]
    log(f"  phase-15 (b) launches, summed over the processes: {json.dumps(deploy_counts)}; "
        f"the runner's kernels not launched there: {unused}  {'ok' if not unused else 'FAIL'}")
    if unused:
        raise AssertionError(f"the deployment launched no {unused}")
    phase_done(15)

    # -- phase 16: the vocabulary trainer at full width ---------------------------
    log(f"[vocab] python -m ccm_slam_tpu_torch.train_vocab --out <temporary file> (in-process "
        f"train_vocab.main on cuda:0: {len(train_vocab.WORLDS) * len(train_vocab.SEEDS)} "
        f"sequences x {train_vocab.N_PER_SEQ} frames at 752x480, {train_vocab.N_FEAT} "
        f"features, {train_vocab.N_WORDS} words x {train_vocab.ITERS} iterations), then "
        f"tests/test_vocab_recall.py's gates on seeds {RECALL_SEEDS}")
    vocab_counts = check_train_vocab(dev, smi, top2_times["8192x32768"]["ms"])
    log(f"  phase-16 launches (the trainer's and the recall transforms'): "
        f"{json.dumps(vocab_counts)}")
    phase_done(16)

    # ``ms_by`` says whether ``ms`` is the profiler's device time or, where
    # its windows miscounted, the CUDA-event time
    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                    launches=gba[name], max_abs_err=errs[name], **times[name])
               for name, replaces in KERNELS]
    kernels.append(dict(name="hamming_top2", route="cuda", source=HAMMING_SOURCE,
                        replaces=f"{PALLAS}:121", launches=reloc["hamming_top2"],
                        max_abs_err=hamming_err, **top2_times["1024x16384"]))
    for name, replaces, err in (("cam_reduce", f"{PALLAS}:284", reduce_err),
                                ("schur_matvec", f"{PALLAS}:496", matvec_err)):
        kernels.append(dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                            launches=prof_counts[name], max_abs_err=err, **new_times[name]))
    for k in kernels:  # phase 14's, 15's and 16's launches beside the path's
        k["launches_sharded_gba"] = dist_counts.get(k["name"], 0)
        k["launches_runner"] = runner_counts.get(k["name"], 0)
        k["launches_deploy"] = deploy_counts.get(k["name"], 0)
        k["launches_train_vocab"] = vocab_counts.get(k["name"], 0)
    log(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
