"""Device times of the port's kernel wrappers against their bounds.

One yardstick for ``chip_smoke.py`` and ``tools/time_ba_kernels.py``: a
wrapper's time is the profiler's device time per call, taken only from a
window whose device kernels per call equal what the wrapper launches
(``DEVICE_KERNELS``); the CUDA-event time stands in after three windows
that miscount, and the result says so (``ms_by``).  Imports torch only: the
kernels module is passed in, so a caller can time any checkout's port.

Cold mode (``flush``): each timed call is preceded by a write of a buffer
twice the card's L2 (``l2_flush``), so that the call finds its inputs in
device memory and L2 full of another kernel's dirty lines, as a caller
between other work would; the flush's own device kernels are picked out by
name and left out of the time and of the kernels-per-call count.
``cam_broadcast`` and its ``index_select`` are timed warm and cold
(``COLD``): their inputs and outputs fit in L2, so back-to-back calls time
L2, not device memory.
"""

from __future__ import annotations

import re
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32, outside the tensor cores
HUBER = 2.447651936
REPS = 100                 # wrapper calls per timing window
POPC_PER_CLK_PER_SM = 16   # 32-bit popcount throughput of sm_90 (CUDA guide)

# device kernels one wrapper call launches
DEVICE_KERNELS = dict(reproj_cost=2, normal_blocks=3, schur_off=3, schur_rhs=3, schur_wtv=1,
                      cam_broadcast=1, cam_reduce=2, schur_matvec=3, hamming_top2=1)
LIBRARY = dict(cam_broadcast="index_select",
               cam_reduce="index_add_, float atomics: not deterministic")
COLD = ("cam_broadcast",)  # kernels timed with L2 flushed as well
L2_BYTES_FALLBACK = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


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


def l2_flush(dev):
    """A function that writes a buffer of twice the card's L2 (PyTorch's
    fill kernel)."""
    size = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 0)
    buf = torch.empty(2 * (size or L2_BYTES_FALLBACK) // 4, dtype=torch.float32, device=dev)
    return buf.zero_


def device_ms(fn, reps, split=None, flush=None):
    """(device ms per call, device kernels per call) over ``reps`` calls:
    the summed time of the device kernels the calls ran, from torch.profiler,
    so host dispatch and the gaps between launches are left out.  None for
    the time when the profiler saw no device activity.  ``split``, a dict,
    receives each device kernel's us per call by its function name.  With
    ``flush`` (``l2_flush``'s function) each call is preceded by a flush,
    whose device kernels (named by a profile of the flush alone) are left
    out."""
    skip = set()
    if flush is not None:
        skip = {e.key for e in device_events(flush)[0]}
    for _ in range(3):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()

    def loop():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()

    device, _ = device_events(loop)
    device = [e for e in device if e.key not in skip]
    busy_us = sum(e.self_device_time_total for e in device)
    n = sum(e.count for e in device) / reps
    if split is not None:
        split.clear()
        for e in device:
            name = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
            key = name.group(1) if name else e.key[:40]
            split[key] = split.get(key, 0.0) + e.self_device_time_total / reps
    return (busy_us / 1e3 / reps if busy_us > 0 else None), n


def retried_ms(fn, reps, flush=None):
    """(device ms per call, device kernels per call) of a plain version or a
    library call: the profiler's, measured again when a window saw no device
    activity (the profiler loses a window now and then), up to three
    windows; then the CUDA-event time, and a line says so."""
    for _ in range(3):
        ms, n = device_ms(fn, reps, flush=flush)
        if ms is not None:
            return ms, n
    log("    the profiler saw no device activity in three windows: the next time is by "
        "CUDA events")
    return event_ms((lambda: (flush(), fn())) if flush is not None else fn, reps), n


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def kernel_ms(fn, reps, want, flush=None):
    """(ms, ms_by, device kernels per call, event ms, split) of a kernel
    wrapper: the profiler's device time per call when it counted ``want``
    device kernels per call (what the wrapper launches), ``ms_by`` "device",
    and ``split`` the us per call of each device kernel.  The profiler loses
    events now and then, so a window that counts otherwise is measured
    again, up to three windows in all; after that the CUDA-event time stands
    in and ``ms_by`` is "events" (with ``flush``, cold: the events then time
    the flushes too)."""
    ev = event_ms((lambda: (flush(), fn())) if flush is not None else fn, reps)
    split = {}
    for _ in range(3):
        ms, n = device_ms(fn, reps, split, flush)
        if ms is not None and n == want:
            return ms, "device", n, ev, split
    log(f"    profiler counted {n:g} device kernels per call where the wrapper launches "
        f"{want}, in three windows: the time below is by CUDA events")
    return ev, "events", n, ev, split


def bound(n_bytes, n_ops, ops_per_s=FP32_FLOP_PER_S):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over their peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_table(table, E, label):
    """Time every entry of ``table`` {name: (kernel fn, plain fn, bytes,
    flops per observation, library fn or None, device kernels per call)} on
    a problem of E observations; returns {name: dict(ms, ms_by, plain_ms,
    bound_ms, bound_by, library_ms)}, the keys of a kernel's result line;
    kernels named in ``COLD`` add ms_cold, ms_cold_by and library_ms_cold.
    A name may carry a case after a space ("cam_broadcast F=6")."""
    out = {}
    flush = None
    for name, (fk, fp, n_bytes, flops_per_obs, flib, want) in table.items():
        ms, ms_by, n_k, ev, split = kernel_ms(fk, REPS, want)
        plain_ms, n_p = retried_ms(fp, REPS // 5)
        lib_ms = retried_ms(flib, REPS)[0] if flib is not None else None
        bound_ms, bound_by = bound(n_bytes, flops_per_obs * E)
        out[name] = dict(ms=ms, ms_by=ms_by, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
        lib_s = f"{lib_ms:.4f} ({LIBRARY[name.split()[0]]})" if lib_ms is not None else "none"
        log(f"  {name:<14} {label}: kernel {ms:.4f} ms by {ms_by}, {n_k:g} device "
            f"kernels/call ({ev:.4f} ms/call by events)  plain {plain_ms:.4f} ms, {n_p:g} "
            f"kernels/call  bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB)  "
            f"library {lib_s}")
        log(f"    {name} device kernels, us per call: "
            + ", ".join(f"{k} {us:.2f}" for k, us in split.items()))
        if name.split()[0] in COLD:
            flush = flush or l2_flush(torch.device("cuda", torch.cuda.current_device()))
            cold, cold_by, n_c, _, split = kernel_ms(fk, REPS, want, flush)
            lib_cold = retried_ms(flib, REPS, flush=flush)[0] if flib is not None else None
            out[name].update(ms_cold=cold, ms_cold_by=cold_by, library_ms_cold=lib_cold)
            lib_s = f"{lib_cold:.4f}" if lib_cold is not None else "none"
            log(f"  {name:<14} {label}, L2 flushed before each call: kernel {cold:.4f} ms by "
                f"{cold_by}, {n_c:g} device kernels/call ("
                + ", ".join(f"{k} {us:.2f} us" for k, us in split.items())
                + f")  library {lib_s}")
    return out


def problem_args(prob):
    return (prob.R, prob.t, prob.X, prob.point_valid, prob.cam_idx, prob.uv,
            prob.sigma2, prob.obs_valid)


def reduce_entry(bk, prob):
    """The ``time_table`` entry of ``bk.cam_reduce`` on a problem's
    observations: an [E,6] array (a CG vector's per-observation rows)
    reduced by the clipped camera ids, the CSR built once (as
    ``pcg_transitions`` builds it); ``index_add_`` into zeros as the library
    call."""
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    E = P * K
    dev = prob.R.device
    ci = prob.cam_idx.reshape(-1).clamp(0, C - 1).contiguous()
    csr = bk.reduce_csr(ci, C)
    y = torch.randn(E, 6, generator=torch.Generator(device="cpu").manual_seed(E)).to(dev)
    ci_l = ci.long()
    return (lambda: bk.cam_reduce(y, ci, C, csr), lambda: bk.cam_reduce_plain(y, ci, C),
            nbytes(y, ci, torch.empty(C, 6)), 1,
            lambda: torch.zeros(C, 6, device=dev).index_add_(0, ci_l, y),
            DEVICE_KERNELS["cam_reduce"])


def blocks_entry(bk, prob, csr):
    """The ``time_table`` entry of ``bk.normal_blocks`` on a problem."""
    C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
    args, intr = problem_args(prob), prob.intr.contiguous()
    return (lambda: bk.normal_blocks(*args, prob.cam_fixed, intr, HUBER, csr),
            lambda: bk.normal_blocks_plain(*args, prob.cam_fixed, intr, HUBER),
            nbytes(*args, prob.cam_fixed, intr, torch.empty(P, K, 6, 3), torch.empty(P, 3, 3),
                   torch.empty(P, 3), torch.empty(C, 6, 6), torch.empty(C, 6),
                   torch.empty((), dtype=torch.float32)), 400, None,
            DEVICE_KERNELS["normal_blocks"])


def cost_entry(bk, prob):
    """The ``time_table`` entry of ``bk.reproj_cost`` on a problem."""
    args, intr = problem_args(prob), prob.intr.contiguous()
    return (lambda: bk.reproj_cost(*args, intr, HUBER),
            lambda: bk.reproj_cost_plain(*args, intr, HUBER),
            nbytes(*args, intr, torch.empty((), dtype=torch.float32)), 40, None,
            DEVICE_KERNELS["reproj_cost"])


def schur_inputs(bk, ba, prob):
    """(W, Vinv) of a problem's first normal-equation pass, damped at 1e-4
    (``ba`` is the port's ``solvers.ba``)."""
    csr = bk.cam_csr(prob.cam_idx, prob.R.shape[0])
    _, V, W, _, _, _ = bk.normal_blocks(*problem_args(prob), prob.cam_fixed,
                                        prob.intr.contiguous(), HUBER, csr)
    return W, ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=W.device))).contiguous()


def off_entry(bk, prob, W, Vinv, v, name="schur_off"):
    """The ``time_table`` entry of the off-diagonal Schur matvec on W, Vinv
    and v [C,6]: ``schur_ops``' off (name "schur_off", the CSR built once per
    solve) or ``make_schur_matvec`` ("schur_matvec")."""
    C = prob.R.shape[0]
    if name == "schur_off":
        off_k = bk.schur_ops(W, Vinv, bk.cam_csr(prob.cam_idx, C))[0]
    else:
        off_k = bk.make_schur_matvec(W, Vinv, prob.cam_idx, C)
    off_p = bk.schur_matvec_plain(W, Vinv, prob.cam_idx, C)
    return (lambda: off_k(v), lambda: off_p(v),
            nbytes(v, W, Vinv, prob.cam_idx, torch.empty(C, 6)), 80, None, DEVICE_KERNELS[name])


def rhs_wtv_entry(bk, prob, W, Vinv, x, name):
    """The ``time_table`` entry of ``schur_ops``' rhs (name "schur_rhs", x =
    q [P,3]) or wtv ("schur_wtv", x = v [C,6]) over W and Vinv, the CSR
    built once per solve."""
    C, (P, _) = prob.R.shape[0], prob.cam_idx.shape
    i = ("schur_rhs", "schur_wtv").index(name) + 1
    fk = bk.schur_ops(W, Vinv, bk.cam_csr(prob.cam_idx, C))[i]
    fp = bk.schur_ops_plain(W, Vinv, prob.cam_idx, C)[i]
    out = torch.empty(C, 6) if name == "schur_rhs" else torch.empty(P, 3)
    return (lambda: fk(x), lambda: fp(x), nbytes(x, W, prob.cam_idx, out), 36, None,
            DEVICE_KERNELS[name])


def broadcast_entry(bk, prob, F):
    """The ``time_table`` entry of ``bk.cam_broadcast`` of a random [C,F]
    table to a problem's observations by the clipped camera ids (F=12: the
    poses of the final statistics; F=6: a CG vector); ``index_select`` as
    the library call."""
    C = prob.R.shape[0]
    E = prob.cam_idx.numel()
    ci = prob.cam_idx.reshape(-1).clamp(0, C - 1).contiguous()
    v = torch.randn(C, F, generator=torch.Generator(device="cpu").manual_seed(F)).to(ci.device)
    return (lambda: bk.cam_broadcast(v, ci), lambda: bk.cam_broadcast_plain(v, ci),
            nbytes(v, ci, torch.empty(E, F)), 0, lambda: torch.index_select(v, 0, ci),
            DEVICE_KERNELS["cam_broadcast"])


def top2_inputs(Q, T, dev, seed=5):
    """(q, qv, t, tv) for ``hamming_top2``: random descriptors, a quarter of
    the targets invalid, target T//2 a copy of target T//3 (a tie, both
    valid) and query 0 equal to it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(0, 256, (Q, 32), generator=g, dtype=torch.uint8)
    t = torch.randint(0, 256, (T, 32), generator=g, dtype=torch.uint8)
    t[T // 2] = t[T // 3]
    q[0] = t[T // 3]
    qv = torch.ones(Q, dtype=torch.bool)
    tv = torch.rand(T, generator=g) >= 0.25
    tv[T // 3] = tv[T // 2] = True
    return tuple(x.to(dev) for x in (q, qv, t, tv))


def top2_plain_rows(hk, q, qv, t, tv, rows=8192):
    """``hamming_top2``'s plain version over blocks of ``rows`` queries (the
    queries are independent): the same outputs, without the dense
    [Q, T] distance matrices of a whole ingest batch at once."""
    out = [hk.hamming_top2_plain(q[i:i + rows], qv[i:i + rows], t, tv)
           for i in range(0, q.shape[0], rows)]
    return tuple(torch.cat(parts) for parts in zip(*out))


def top2_timing(hk, args, rate, label, plain=None):
    """``hamming_top2`` (``hk`` its module) on ``args`` as ``time_table``
    reports a kernel (warm: it reads under 1 MB).  The bound: its bytes, or
    this run's valid (query, target) pairs at the tensor cores' 1-bit rate,
    ``rate`` being ``tools/mma_b1_rate.measure``'s result; ``popc_bound_ms``
    beside it reckons the same pairs at 8 popcounts each, 16 per clock per
    SM at the largest SM clock (the bound of a popcount kernel).  ``plain``
    is the plain version timed (``hk.hamming_top2_plain`` by default)."""
    q, qv, t, tv = args
    pairs_per_s = rate["pairs_per_s"]
    popc_per_s = POPC_PER_CLK_PER_SM * rate["sms"] * rate["max_sm_clock_mhz"] * 1e6
    ms, ms_by, n, ev, split = kernel_ms(lambda: hk.hamming_top2(q, qv, t, tv), REPS,
                                       DEVICE_KERNELS["hamming_top2"])
    plain = hk.hamming_top2_plain if plain is None else plain
    plain_ms, _ = retried_ms(lambda: plain(q, qv, t, tv), 5)
    pairs = int(qv.sum()) * int(tv.sum())
    n_bytes = nbytes(q, qv, t, tv, torch.empty(3, q.shape[0], dtype=torch.int32))
    bound_ms, bound_by = bound(n_bytes, pairs, pairs_per_s)
    popc_ms = bound(n_bytes, 8 * pairs, popc_per_s)[0]
    log(f"  hamming_top2 {label}: kernel {ms:.4f} ms by {ms_by} ({n:g} device kernels/call; "
        f"{ev:.4f} ms by events), plain {plain_ms:.4f} ms device, bound {bound_ms:.4f} ms "
        f"({bound_by}: {pairs / 1e6:.2f} M valid pairs at {pairs_per_s / 1e12:.3f} T pairs/s, "
        f"the 1-bit MMA; {n_bytes / 1e6:.2f} MB), popcount bound {popc_ms:.4f} ms, library none")
    log("    hamming_top2 device kernels, us per call: "
        + ", ".join(f"{k} {us:.2f}" for k, us in split.items()))
    return dict(ms=ms, ms_by=ms_by, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, popc_bound_ms=popc_ms)
