"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ccm_slam_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card, and drives the port's paths through their
entry points with the launch counts set to 0 before each path and held to
that path's own expected counts after it:

  1. device and build;
  2. the BA kernels at the server-GBA shapes and on a ragged case;
  3. server-scale global BA (PCG branch), local-BA-size BA (dense branch),
     an interrupted (chunked) solve, the pose-only tracking step;
  4. BA times;
  5. ``hamming_top2`` against its plain version: 1024 x 16384 with a quarter
     of the targets invalid, a ragged case, invalid queries, a single valid
     target -- equal outputs, and bit-identical on a second run;
  6. the client bootstrap at 752x480: rendered corridor frames (EuRoC
     intrinsics and radtan) -> ``orb.extract`` -> ``build_frame`` ->
     ``search_for_initialization`` -> ``initialize_two_view``, gated on the
     renderer's ground truth, and the same frames through the port on the
     CPU;
  7. global relocalization: a later frame's features ``match_brute``-d
     against a 16384-slot landmark arena (the ``hamming_top2`` kernel), then
     ``ransac_pnp`` and a pose refine, gated as the tracker gates it;
  8. front-end times (medians of 5 runs with their spread).

It prints one line per step, the card's name and power limit as
``nvidia-smi`` reports them, on the line before the last ``{"kernels":
[...]}`` (each kernel's launches on its path, error against its plain
version, device time, plain time, bound and library yardstick), and last
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present or any
phase fails.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ccm_slam_tpu_torch import config, convert, problems
from ccm_slam_tpu_torch.io.rendered import RenderedSequence
from ccm_slam_tpu_torch.ops import _build, ba_kernels as bk, hamming, hamming_kernels as hk
from ccm_slam_tpu_torch.ops import initializer, matching, orb, pnp
from ccm_slam_tpu_torch.runtime.frame import build_frame
from ccm_slam_tpu_torch.solvers import ba, pose_opt
from ccm_slam_tpu_torch.utils.camera import Camera

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32, outside the tensor cores
POPC_PER_CLK_PER_SM = 16   # 32-bit popcount throughput of sm_90 (CUDA guide)
HUBER = 2.447651936
CG_ITERS = 16              # ba_solve's cap on CG steps per LM iteration
SOURCE = "ccm_slam_tpu_torch/csrc/ba_kernels.cu"
HAMMING_SOURCE = "ccm_slam_tpu_torch/csrc/hamming_kernels.cu"
PALLAS = "ccm_slam_tpu/ops/pallas_kernels.py"
# (name, the TPU kernel's pallas_call it replaces, flops per observation)
KERNELS = [
    ("reproj_cost", f"{PALLAS}:1097", 40),
    ("normal_blocks", f"{PALLAS}:967", 400),
    ("schur_off", f"{PALLAS}:634", 80),
    ("schur_rhs", f"{PALLAS}:648", 36),
    ("schur_wtv", f"{PALLAS}:660", 36),
    ("cam_broadcast", f"{PALLAS}:324", 0),
]

# the __global__ functions of csrc/ba_kernels.cu (without the _kernel suffix)
CUDA_KERNELS = ("reproj_cost", "normal_blocks", "seg_sum", "sum_partials", "schur_off",
                "schur_rhs", "schur_wtv", "cam_broadcast")

# the bootstrap pair and the relocalization frame of
# RenderedSequence("corridor", seed=0, n_frames=200, span=(0, 0.22)), and the
# JAX package's own errors on that pair against ground truth (rotation,
# translation direction; degrees), from ``python3 tools/jax_init_pair.py``
INIT_PAIR = (0, 6)
RELOC_FRAME = 10
JAX_PAIR_ERR_DEG = (0.1228, 1.4517)
MIN_ERR_GATE_DEG = (0.5, 5.0)

# Tolerances, kernel against plain version (both fp32 on the card).  Sums
# are taken in another order (CSR segments and tree sums against index_add_
# and einsum), so sums get a tolerance scaled by the largest entry; the
# elementwise outputs (W, the broadcast) carry only FMA-contraction noise.
TOL_BLOCKS = 5e-3      # rtol for U, V, W, g_c, g_p (atol 1e-5 * max|ref|)
TOL_COST = 1e-4        # relative, on the Huber cost sum (+1e-2 absolute)
TOL_SCHUR = 1e-4       # rtol for off/rhs/wtv (atol 1e-4 * max|ref|)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def problem_args(prob):
    return (prob.R, prob.t, prob.X, prob.point_valid, prob.cam_idx, prob.uv,
            prob.sigma2, prob.obs_valid)


def check_kernels(prob, rng, label):
    """Every kernel against its plain version on ``prob``; returns
    {kernel: max_abs_err} and the inputs used, for timing."""
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    dev = prob.R.device
    log(f"[kernels] {label}: C={C} P={P} K={K}")
    intr = prob.intr.contiguous()
    csr = bk.cam_csr(prob.cam_idx, C)
    errs = {}

    cost_k = bk.reproj_cost(*problem_args(prob), intr, HUBER)
    cost_p = bk.reproj_cost_plain(*problem_args(prob), intr, HUBER)
    errs["reproj_cost"] = compare_cost("reproj_cost", cost_k, cost_p)

    out_k = bk.normal_blocks(*problem_args(prob), prob.cam_fixed, intr, HUBER, csr)
    out_p = bk.normal_blocks_plain(*problem_args(prob), prob.cam_fixed, intr, HUBER)
    nb_err = 0.0
    for part, a, b in zip(("U", "V", "W", "g_c", "g_p"), out_k[:5], out_p[:5]):
        nb_err = max(nb_err, compare(f"normal_blocks.{part}", a, b, TOL_BLOCKS, 1e-5))
    compare_cost("normal_blocks.cost", out_k[5], out_p[5])
    errs["normal_blocks"] = nb_err
    U, V, W = out_k[0], out_k[1], out_k[2]
    fixed = prob.cam_fixed.nonzero().flatten()
    if fixed.numel() and float(U[fixed].abs().max()) != 0.0:
        raise AssertionError("normal_blocks: fixed cameras must get zero U")

    Vinv = ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=dev))).contiguous()
    v = torch.as_tensor(rng.standard_normal((C, 6)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.standard_normal((P, 3)).astype(np.float32), device=dev)
    ops_k = bk.schur_ops(W, Vinv, csr)
    ops_p = bk.schur_ops_plain(W, Vinv, prob.cam_idx, C)
    for name, fk, fp, x in zip(("schur_off", "schur_rhs", "schur_wtv"), ops_k, ops_p,
                               (v, q, v)):
        errs[name] = compare(name, fk(x), fp(x), TOL_SCHUR, 1e-4)

    # on the path the broadcast carries the 12 pose floats (R | t) per camera
    ci = csr.ci.reshape(-1)
    Rt = torch.cat([prob.R.reshape(C, 9), prob.t], dim=-1).contiguous()
    errs["cam_broadcast"] = compare("cam_broadcast", bk.cam_broadcast(Rt, ci),
                                    bk.cam_broadcast_plain(Rt, ci), 0.0, 0.0)
    torch.cuda.synchronize()
    inputs = dict(prob=prob, intr=intr, csr=csr, W=W, Vinv=Vinv, v=v, q=q, Rt=Rt, ci=ci)
    return errs, inputs


def event_ms(fn, reps):
    """Mean time per call over ``reps`` back-to-back calls, CUDA events:
    host dispatch included wherever it outlasts the device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn):
    """torch.profiler's averages of the device kernels that ``fn`` runs, and
    the wall ms of ``fn`` under the profiler (its start and stop left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return device, wall_ms


def device_ms(fn, reps):
    """(device ms per call, device kernels per call) over ``reps`` calls:
    the summed time of the device kernels the calls ran, from torch.profiler,
    so host dispatch and the gaps between launches are left out.  None for
    the time when the profiler saw no device activity."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def loop():
        for _ in range(reps):
            fn()

    device, _ = device_events(loop)
    busy_us = sum(e.self_device_time_total for e in device)
    n = sum(e.count for e in device) / reps
    return (busy_us / 1e3 / reps if busy_us > 0 else None), n


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def kernel_timings(inp):
    """(ms, plain_ms, bound_ms, bound_by, library_ms) per kernel: device
    times from the profiler (CUDA events where it sees no device work)."""
    prob, intr, csr = inp["prob"], inp["intr"], inp["csr"]
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    E = P * K
    args = problem_args(prob)
    W, Vinv, v, q, Rt, ci = (inp[k] for k in ("W", "Vinv", "v", "q", "Rt", "ci"))
    off_k, rhs_k, wtv_k = bk.schur_ops(W, Vinv, csr)
    off_p, rhs_p, wtv_p = bk.schur_ops_plain(W, Vinv, prob.cam_idx, C)
    scalar = torch.empty((), dtype=torch.float32)
    c6, p3 = torch.empty(C, 6), torch.empty(P, 3)
    table = {
        "reproj_cost": (
            lambda: bk.reproj_cost(*args, intr, HUBER),
            lambda: bk.reproj_cost_plain(*args, intr, HUBER),
            nbytes(*args, intr, scalar), None),
        "normal_blocks": (
            lambda: bk.normal_blocks(*args, prob.cam_fixed, intr, HUBER, csr),
            lambda: bk.normal_blocks_plain(*args, prob.cam_fixed, intr, HUBER),
            nbytes(*args, prob.cam_fixed, intr, W, torch.empty(P, 3, 3), p3,
                   torch.empty(C, 6, 6), c6, scalar), None),
        "schur_off": (lambda: off_k(v), lambda: off_p(v),
                      nbytes(v, W, Vinv, prob.cam_idx, c6), None),
        "schur_rhs": (lambda: rhs_k(q), lambda: rhs_p(q),
                      nbytes(q, W, prob.cam_idx, c6), None),
        "schur_wtv": (lambda: wtv_k(v), lambda: wtv_p(v),
                      nbytes(v, W, prob.cam_idx, p3), None),
        "cam_broadcast": (
            lambda: bk.cam_broadcast(Rt, ci), lambda: bk.cam_broadcast_plain(Rt, ci),
            nbytes(Rt, ci, torch.empty(E, Rt.shape[1])),
            lambda: torch.index_select(Rt, 0, ci)),
    }

    def timed(fn, reps):
        dev_ms, n = device_ms(fn, reps)
        ev_ms = event_ms(fn, reps)
        return (dev_ms if dev_ms is not None else ev_ms), ev_ms, n, dev_ms is not None

    out = {}
    for name, _, flops_per_obs in KERNELS:
        fk, fp, n_bytes, flib = table[name]
        ms, ev, n_k, prof_ok = timed(fk, 100)
        plain_ms, plain_ev, n_p, _ = timed(fp, 20)
        lib_ms = timed(flib, 100)[0] if flib is not None else None
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops_per_obs * E / FP32_FLOP_PER_S * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out[name] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        how = "device" if prof_ok else "events (profiler saw no device time)"
        log(f"  {name:<14} kernel {ms:.4f} ms {how}, {n_k:g} device kernels/call "
            f"({ev:.4f} ms/call by events)  plain {plain_ms:.4f} ms, {n_p:g} kernels/call "
            f"({plain_ev:.4f} by events)  bound {bound_ms:.4f} ms ({bound_by}, "
            f"{n_bytes / 1e6:.1f} MB)  library {lib_s}")
    return out


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
    name must stay at 0).  Returns (fn's result, the counts)."""
    bk.reset_launch_counts()
    hk.reset_launch_counts()
    out = fn()
    counts = {**bk.launch_counts(), **hk.launch_counts()}
    bad = {}
    for name, n in counts.items():
        w = want.get(name, 0)
        lo, hi = w if isinstance(w, tuple) else (w, w)
        if not lo <= n <= hi:
            bad[name] = f"{n}, expected {w}"
    log(f"  launches, {label}: {json.dumps(counts)}  {'ok' if not bad else 'FAIL'}")
    if bad:
        raise AssertionError(f"{label}: launch counts off: {bad}")
    return out, counts


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
    ours = [e for e in device if any(f"{name}_kernel" in e.key for name in CUDA_KERNELS)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3
    log(f"[times] profiled solve: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), of it the port's kernels "
        f"{ours_ms:.2f} ms; {sum(e.count for e in device)} device kernels")
    for name in CUDA_KERNELS:
        evs = [e for e in ours if f"{name}_kernel" in e.key]
        n = sum(e.count for e in evs)
        if n:
            us = sum(e.self_device_time_total for e in evs)
            log(f"  in the solve: {name}_kernel x{n}, {us / n:.2f} us each, "
                f"{us / 1e3:.3f} ms in all")


# ---------------------------------------------------------------------------
# The front-end: hamming_top2, the bootstrap and global relocalization.
# ---------------------------------------------------------------------------


def top2_cases(dev):
    """Phase-5 inputs {name: (q, qv, t, tv)}: the relocalization shape with a
    quarter of the targets invalid, a ragged case, 30 invalid queries, and a
    single valid target; each with a duplicated target (a tie)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    cases = {}
    for name, Q, Tn in (("1024x16384", 1024, 16384), ("ragged 100x300", 100, 300),
                        ("30 invalid queries", 128, 256), ("one valid target", 64, 500)):
        q = torch.randint(0, 256, (Q, 32), generator=g, dtype=torch.uint8)
        t = torch.randint(0, 256, (Tn, 32), generator=g, dtype=torch.uint8)
        t[Tn // 2] = t[Tn // 3]
        q[0] = t[Tn // 3]
        qv = torch.ones(Q, dtype=torch.bool)
        tv = torch.rand(Tn, generator=g) >= 0.25
        tv[Tn // 3] = tv[Tn // 2] = True
        if name.startswith("30"):
            qv[-30:] = False
        if name.startswith("one"):
            tv[:] = False
            tv[Tn - 7] = True
        cases[name] = tuple(x.to(dev) for x in (q, qv, t, tv))
    return cases


def check_hamming(dev):
    """hamming_top2 against its plain version on every phase-5 case: equal
    outputs, and a second run bit-identical.  Returns the max abs error."""
    err = 0
    for name, args in top2_cases(dev).items():
        out = hk.hamming_top2(*args)
        again = hk.hamming_top2(*args)
        ref = hk.hamming_top2_plain(*args)
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


def landmark_arena(frames, m_idx, out, dev):
    """A client-map-sized landmark arena (client_max_mps slots): the
    bootstrap's good landmarks first, with the current frame's descriptors
    (``tracking.initialize_map``), the rest seeded random descriptors; all
    valid.  Returns (positions [M,3], descriptors [M,32], valid [M], n_good)."""
    M = config.CapacityConfig().client_max_mps
    good = out["good"] & out["success"]
    n_good = int(good.sum())
    g = torch.Generator(device="cpu").manual_seed(11)
    desc = torch.randint(0, 256, (M, 32), generator=g, dtype=torch.uint8).to(dev)
    pos = torch.zeros(M, 3, dtype=torch.float32, device=dev)
    desc[:n_good] = frames[1].desc[m_idx[good]]
    pos[:n_good] = out["X"][good]
    return pos, desc, torch.ones(M, dtype=torch.bool, device=dev), n_good


def relocalize(fe, frame, arena, generator):
    """``Tracker._pnp_recover``'s steps: brute match against the arena,
    RANSAC-PnP, pose refine on the inlier associations."""
    pos, desc, valid, _ = arena
    t_idx, _, okm = matching.match_brute(frame.desc, frame.valid, desc, valid,
                                         th_dist=matching.TH_LOW, nn_ratio=0.75,
                                         check_rotation=False)
    X = pos[t_idx]
    cam = fe.cam
    res = pnp.ransac_pnp(X, frame.xy, okm, frame.sigma2, cam.fx, cam.fy, cam.cx, cam.cy,
                         generator=generator)
    R, t, inl, n_in = pose_opt.optimize_pose(res["R"], res["t"], X, frame.xy,
                                             okm & res["inliers"], frame.sigma2,
                                             cam.fx, cam.fy, cam.cx, cam.cy)
    return okm, res, (R, t, inl, n_in)


def check_relocalization(fe, seq, arena, dev):
    """Phase 7: a later frame relocalized against the arena; the tracker's
    gates (>= 15 matches, >= 15 PnP inliers) and 1 degree of ground truth."""
    frame = fe.frame(fe.features(RELOC_FRAME, False), RELOC_FRAME)
    gen = torch.Generator(device=dev).manual_seed(1)
    (okm, res, (R, t, _, n_in)), counts = counted(
        "relocalization", lambda: relocalize(fe, frame, arena, gen), {"hamming_top2": 1})
    R_gt, t_gt = relative_gt(seq, INIT_PAIR[0], RELOC_FRAME)
    e_rot, e_dir = rot_err_deg(R, R_gt), dir_err_deg(t, t_gt)
    n_match, n_pnp = int(okm.sum()), int(res["n_inliers"])
    ok = n_match >= 15 and bool(res["success"]) and n_pnp >= 15 and e_rot <= 1.0
    log(f"  frame {RELOC_FRAME} vs {arena[1].shape[0]} landmarks ({arena[3]} from the "
        f"bootstrap): {n_match} matches (>= 15), PnP inliers {n_pnp} (>= 15), refined "
        f"inliers {int(n_in)}; rotation error {e_rot:.4f} deg (<= 1), translation direction "
        f"error {e_dir:.4f} deg  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("relocalization failed its gates")
    return frame, counts


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


def sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def hamming_timing(dev):
    """(ms, plain_ms, bound_ms, bound_by) of hamming_top2 at 1024 x 16384:
    device times from the profiler; the bound from this run's valid pairs
    (the kernel skips invalid targets) at 16 popcounts per clock per SM."""
    q, qv, t, tv = top2_cases(dev)["1024x16384"]
    ms, n = device_ms(lambda: hk.hamming_top2(q, qv, t, tv), 50)
    ev = event_ms(lambda: hk.hamming_top2(q, qv, t, tv), 50)
    plain_ms, _ = device_ms(lambda: hk.hamming_top2_plain(q, qv, t, tv), 5)
    ms = ms if ms is not None else ev
    clock = sm_clock_mhz() * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    popc = int(qv.sum()) * int(tv.sum()) * 8
    t_ops = popc / (POPC_PER_CLK_PER_SM * sms * clock) * 1e3
    outputs = torch.empty(3, q.shape[0], dtype=torch.int32)
    t_bytes = nbytes(q, qv, t, tv, outputs) / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"  hamming_top2 1024x16384: kernel {ms:.4f} ms device ({n:g} device kernels/call; "
        f"{ev:.4f} ms by events), plain {plain_ms:.4f} ms device, bound {bound_ms:.4f} ms "
        f"({bound_by}: {popc / 1e6:.1f} M popcounts at {POPC_PER_CLK_PER_SM}/clk/SM x {sms} SMs "
        f"x {clock / 1e9:.3f} GHz; bytes {t_bytes * 1e3:.2f} us), library none")
    return ms, plain_ms, bound_ms, bound_by


def front_end_timings(fe, frames, m_idx, m_ok, arena, reloc_frame):
    """Wall ms (5 runs after a warm-up, each ending in a sync) of each
    front-end step at EuRoC width."""
    f1, f2 = frames
    cam = fe.cam
    gen = torch.Generator(device=fe.dev).manual_seed(2)
    pos, desc, valid, _ = arena
    t_idx, _, okm = matching.match_brute(reloc_frame.desc, reloc_frame.valid, desc, valid,
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
         lambda: matching.match_brute(reloc_frame.desc, reloc_frame.valid, desc, valid,
                                      check_rotation=False)),
        ("ransac_pnp, 200 hypotheses + refine",
         lambda: pnp.ransac_pnp(pos[t_idx], reloc_frame.xy, okm, reloc_frame.sigma2, cam.fx,
                                cam.fy, cam.cx, cam.cy, generator=gen)),
        ("relocalization: match_brute + ransac_pnp + pose refine",
         lambda: relocalize(fe, reloc_frame, arena, gen)),
    ]
    for label, fn in steps:
        log(f"  {label}: {spread(walls_ms(fn))}")
        device, wall = device_events(fn)
        busy = sum(e.self_device_time_total for e in device) / 1e3
        log(f"    profiled once: wall {wall:.3f} ms (profiler on), device busy {busy:.3f} ms "
            f"({busy / wall:.1%}), {sum(e.count for e in device)} device kernels")


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
    libs = _build.build_all(["ba_kernels", "hamming_kernels"])  # one nvcc each, in parallel
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {line.strip()}")

    # -- phase 2: kernels against their plain versions ---------------------
    rng = np.random.default_rng(0)
    bench = problems.make_problem(device=dev)
    errs, inputs = check_kernels(bench, rng, "bench shapes")
    check_kernels(convert.ba_problem_from_numpy(problems.ragged_problem_arrays(), dev),
                  rng, "ragged")
    Cr = 37
    v = torch.as_tensor(rng.standard_normal((Cr, 5)).astype(np.float32), device=dev)
    ci = torch.as_tensor(rng.integers(-3, Cr + 3, 999).astype(np.int32), device=dev)
    compare("cam_broadcast.oob", bk.cam_broadcast(v, ci), bk.cam_broadcast_plain(v, ci),
            0.0, 0.0)
    log("[kernels] all kernels agree with their plain versions")

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

    # -- phase 4: times ------------------------------------------------------
    log(f"[times] kernels at bench shapes; {smi}")
    times = kernel_timings(inputs)
    walls = time_solve(bench, 20, 5)
    wall = statistics.median(walls)
    kernel_ms = sum(gba[name] * times[name][0] for name in times)
    log(f"[times] ba_solve C=128 P=32768 K=8, 20 iterations, 5 runs: "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; median {wall * 1e3:.2f} ms, "
        f"{wall / 20 * 1e3:.3f} ms per LM iteration ({20 / wall:.1f} iters/s); the port's "
        f"kernels {kernel_ms:.2f} ms of it by device time ({gba['schur_off'] - 20} CG "
        f"steps, one host sync each)")
    profile_solve(bench)

    # -- phase 5: hamming_top2 against its plain version --------------------
    log("[kernels] hamming_top2 against its plain version")
    hamming_err = check_hamming(dev)

    # -- phase 6: the client bootstrap at 752x480 ----------------------------
    t0 = time.perf_counter()
    seq = RenderedSequence(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22),
                           cam=config.CameraConfig())
    images = {i: seq.render_frame(i) for i in (*INIT_PAIR, RELOC_FRAME)}
    log(f"[front-end] rendered frames {sorted(images)} at 752x480 in "
        f"{time.perf_counter() - t0:.1f} s")
    log("[front-end] bootstrap: extract -> build_frame -> search_for_initialization -> "
        "initialize_two_view (no kernel on this path)")
    fe, frames, m_idx, m_ok, out = check_bootstrap(seq, images, dev)

    # -- phase 7: global relocalization --------------------------------------
    log("[front-end] relocalization: match_brute (hamming_top2) -> ransac_pnp -> refine")
    arena = landmark_arena(frames, m_idx, out, dev)
    reloc_frame, reloc = check_relocalization(fe, seq, arena, dev)

    # -- phase 8: front-end times ----------------------------------------------
    log(f"[times] front-end at 752x480; {smi}")
    top2_times = hamming_timing(dev)
    front_end_timings(fe, frames, m_idx, m_ok, arena, reloc_frame)

    kernels = []
    for name, replaces, _ in KERNELS:
        ms, plain_ms, bound_ms, bound_by, lib_ms = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=gba[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
    ms, plain_ms, bound_ms, bound_by = top2_times
    kernels.append(dict(
        name="hamming_top2", route="cuda", source=HAMMING_SOURCE, replaces=f"{PALLAS}:121",
        launches=reloc["hamming_top2"], max_abs_err=hamming_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    log(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
