"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ccm_slam_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card (at the server-GBA
shapes and on a ragged case), drives the port's slice -- server-scale global
BA (PCG branch), local-BA-size BA (dense branch), an interrupted (chunked)
solve and the pose-only tracking step -- with the launch counts set to 0
before each path and held to that path's own expected counts after it,
checks the results, times every kernel, and prints:

  * one line per phase;
  * the card's name and power limit as ``nvidia-smi`` reports them;
  * on the line before the last, ``{"kernels": [...]}`` with each kernel's
    launches on the server-GBA solve, error against its plain version,
    device time, plain time, bound and library yardstick;
  * last, ``{"ok": true, "device": {...}}``.

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

from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.ops import _build, ba_kernels as bk
from ccm_slam_tpu_torch.solvers import ba, pose_opt

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32, outside the tensor cores
HUBER = 2.447651936
CG_ITERS = 16              # ba_solve's cap on CG steps per LM iteration
SOURCE = "ccm_slam_tpu_torch/csrc/ba_kernels.cu"
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
    out = fn()
    counts = bk.launch_counts()
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
    lib = _build.build("ba_kernels")
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("ba_kernels").splitlines():
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
    kernel_ms = sum(gba[name] * times[name][0] for name in gba)
    log(f"[times] ba_solve C=128 P=32768 K=8, 20 iterations, 5 runs: "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; median {wall * 1e3:.2f} ms, "
        f"{wall / 20 * 1e3:.3f} ms per LM iteration ({20 / wall:.1f} iters/s); the port's "
        f"kernels {kernel_ms:.2f} ms of it by device time ({gba['schur_off'] - 20} CG "
        f"steps, one host sync each)")
    profile_solve(bench)

    kernels = []
    for name, replaces, _ in KERNELS:
        ms, plain_ms, bound_ms, bound_by, lib_ms = times[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=gba[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
    log(f"[device] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
