"""Time the kernels of one checkout of the port where the main path runs them.

    python3 tools/time_ba_kernels.py [--root DIR] [--label NAME]
                                     [--device-kernels NAME=N,...]

Imports ``ccm_slam_tpu_torch`` from ``--root`` (default: this repository),
so two checkouts (for example an older commit unpacked with ``git archive``
into an ignored directory, and this one) can be timed in turns in one call
on one card.  The problems are built first, as numpy arrays, by THIS
checkout's ``problems`` (so both turns time the same inputs, and an older
checkout can be timed at a shape its own ``problems`` lacks); then only the
port of ``--root`` is imported.  Needs a CUDA card; builds the kernels of
that checkout.  The timing itself is ``tools/kernel_timing.py``, the
yardstick of ``chip_smoke.py``: the profiler's device time per call from
windows that count the device kernels the wrapper launches
(``kernel_timing.DEVICE_KERNELS``; ``--device-kernels`` states another
checkout's counts, e.g. ``hamming_top2=2`` for code whose
``hamming_top2`` ran a partial and a merge kernel), else CUDA events
(``ms_by``).  ``cam_broadcast`` and its ``index_select`` are timed warm and
with L2 flushed before each call (``kernel_timing.COLD``).

Shapes and what runs there on the main path:
  bench     C=128,  P=32,768,  K=8   server GBA (every kernel; one
                                     ``cam_broadcast`` F=12 per solve)
  init BA   C=160,  P=24,576,  K=16  the client's initialization BA, its
                                     empty slots on camera 0 (``schur_off``,
                                     ``schur_rhs``, ``schur_wtv``,
                                     ``reproj_cost``, ``normal_blocks``,
                                     ``cam_broadcast`` F=12)
  local BA  C=40,   P=4,096,   K=16  the client's local BA, dense branch
                                     (``reproj_cost``, ``normal_blocks``,
                                     ``cam_broadcast`` F=12: 66 of the
                                     client loop's 67)
  stress    C=1024, P=131,072, K=8   ``profile_gba`` (``make_schur_matvec``,
                                     ``schur_rhs``, ``schur_wtv``,
                                     ``cam_broadcast`` at F=6 and F=12,
                                     ``reproj_cost``, ``normal_blocks``,
                                     ``cam_reduce``)
``cam_reduce`` (F=6, the clipped ids) is timed at every shape as well.
``hamming_top2`` is timed at 1,024 x 1,024 (``track_reference_kf``; loop
closing's keyframe pairs), 1,024 x 16,384 and 1,024 x 24,576
(relocalization against the arena), on ``kernel_timing.top2_inputs``, its
bound from the 1-bit MMA rate that ``tools/mma_b1_rate.py`` measures first
in the same run (this checkout's probe).
Last, after every kernel window (the profiler has lost events in windows
that follow a long one), one 20-iteration ``ba_solve`` at the bench and
init-BA shapes (both on the PCG branch) under the profiler: its device time
(all device kernels, the port's and PyTorch's) and its CG steps beside its
wall time.

Prints one JSON line per (kernel, shape): ``kernel_timing.time_table``'s
or ``top2_timing``'s result (device ms per call, how it was measured, the
plain version's ms, the bound, ``index_add_``'s ms for ``cam_reduce`` and
``index_select``'s for ``cam_broadcast``, warm and cold) with the card's
name and power limit, and first the probe's line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import kernel_timing as kt
import mma_b1_rate

HERE = Path(__file__).resolve().parents[1]
# shape -> kernels timed there
SCHUR = ("schur_off", "schur_rhs", "schur_wtv")
KERNELS = {
    "bench C=128 P=32768 K=8": ("normal_blocks", "cam_reduce", "reproj_cost", *SCHUR,
                                "cam_broadcast F=12"),
    "init BA C=160 P=24576 K=16": ("normal_blocks", "cam_reduce", "reproj_cost", *SCHUR,
                                   "cam_broadcast F=12"),
    "local BA C=40 P=4096 K=16": ("normal_blocks", "cam_reduce", "reproj_cost",
                                  "cam_broadcast F=12"),
    "stress C=1024 P=131072 K=8": ("normal_blocks", "cam_reduce", "reproj_cost", "schur_matvec",
                                   "schur_rhs", "schur_wtv", "cam_broadcast F=6",
                                   "cam_broadcast F=12"),
}
TOP2_SHAPES = ((1024, 1024), (1024, 16384), (1024, 24576))  # (queries, targets)


def build_arrays():
    """{shape: numpy problem arrays}, from this checkout's ``problems``;
    the package is then dropped from ``sys.modules``."""
    sys.path.insert(0, str(HERE))
    from ccm_slam_tpu_torch import problems

    arrays = {
        "bench C=128 P=32768 K=8": problems.ba_problem_arrays(C=128, P=32768, K=8),
        "init BA C=160 P=24576 K=16": problems.init_ba_problem_arrays(),
        "local BA C=40 P=4096 K=16": problems.ba_problem_arrays(C=40, P=4096, K=16),
        "stress C=1024 P=131072 K=8": problems.stress_problem_arrays(),
    }
    sys.path.remove(str(HERE))
    for name in [m for m in sys.modules if m.split(".")[0] == "ccm_slam_tpu_torch"]:
        del sys.modules[name]
    return arrays


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--device-kernels", default="",
                    help="NAME=N,... device kernels per wrapper call of the checkout timed")
    a = ap.parse_args()
    for item in filter(None, a.device_kernels.split(",")):
        name, n = item.split("=")
        kt.DEVICE_KERNELS[name] = int(n)

    if not torch.cuda.is_available():
        print("time_ba_kernels: no CUDA device available", file=sys.stderr)
        return 2
    arrays = build_arrays()
    root = Path(a.root).resolve()
    sys.path.insert(0, str(root))
    from ccm_slam_tpu_torch import convert
    from ccm_slam_tpu_torch.ops import ba_kernels as bk, hamming_kernels as hk
    from ccm_slam_tpu_torch.solvers import ba

    kt.log(f"[time_ba_kernels] {a.label}: kernels of {Path(bk.__file__).parents[1]}")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    rate = mma_b1_rate.measure(dev)
    print(json.dumps(dict(code=a.label, kernel="mma_b1_rate", card=smi, **rate)), flush=True)
    if not rate["tile_ok"]:
        raise AssertionError("mma_b1_rate: the 1-bit MMA tile disagrees with host popcounts")
    for Q, T in TOP2_SHAPES:
        shape = f"{Q} x {T}"
        res = kt.top2_timing(hk, kt.top2_inputs(Q, T, dev), rate, f"{a.label} {shape}")
        print(json.dumps(dict(code=a.label, kernel="hamming_top2", shape=shape, card=smi, **res)),
              flush=True)
    for shape, names in KERNELS.items():
        prob = convert.ba_problem_from_numpy(arrays[shape], dev)
        C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
        entries = {"normal_blocks": lambda: kt.blocks_entry(bk, prob, bk.cam_csr(prob.cam_idx, C)),
                   "cam_reduce": lambda: kt.reduce_entry(bk, prob),
                   "reproj_cost": lambda: kt.cost_entry(bk, prob),
                   "cam_broadcast F=6": lambda: kt.broadcast_entry(bk, prob, 6),
                   "cam_broadcast F=12": lambda: kt.broadcast_entry(bk, prob, 12)}
        if "schur_rhs" in names:
            W, Vinv = kt.schur_inputs(bk, ba, prob)
            rng = np.random.default_rng(C)
            v = torch.as_tensor(rng.standard_normal((C, 6)), dtype=torch.float32, device=dev)
            q = torch.as_tensor(rng.standard_normal((P, 3)), dtype=torch.float32, device=dev)
            for name in ("schur_off", "schur_matvec"):
                entries[name] = lambda name=name: kt.off_entry(bk, prob, W, Vinv, v, name)
            for name, x in (("schur_rhs", q), ("schur_wtv", v)):
                entries[name] = lambda name=name, x=x: kt.rhs_wtv_entry(bk, prob, W, Vinv, x, name)
        table = {name: entries[name]() for name in names}
        for name, res in kt.time_table(table, P * K, f"{a.label} {shape}").items():
            print(json.dumps(dict(code=a.label, kernel=name, shape=shape, card=smi, **res)),
                  flush=True)
        del prob, table, entries
        torch.cuda.empty_cache()
    for shape in ("bench C=128 P=32768 K=8", "init BA C=160 P=24576 K=16"):
        prob = convert.ba_problem_from_numpy(arrays[shape], dev)
        ba.ba_solve(prob, iters=20)
        bk.reset_launch_counts()
        device, wall_ms = kt.device_events(lambda: ba.ba_solve(prob, iters=20))
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        n = sum(e.count for e in device)
        cg = bk.launch_counts()["schur_off"] - 20  # one off per LM iteration, one per CG step
        kt.log(f"  ba_solve {a.label} {shape}, 20 iterations: device {busy_ms:.3f} ms, "
               f"{n} device kernels, {cg} CG steps, wall {wall_ms:.3f} ms (profiler on)")
        print(json.dumps(dict(code=a.label, kernel="ba_solve 20 iterations", shape=shape,
                              card=smi, device_ms=busy_ms, device_kernels=n, cg_steps=cg,
                              wall_ms=wall_ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
