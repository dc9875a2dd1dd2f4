"""Time ``normal_blocks`` and ``cam_reduce`` of one checkout of the port.

    python3 tools/time_ba_kernels.py [--root DIR] [--label NAME]

Imports ``ccm_slam_tpu_torch`` from ``--root`` (default: this repository),
so two checkouts (for example an older commit unpacked with ``git archive``
into an ignored directory, and this one) can be timed in turns in one call
on one card.  Needs a CUDA card; builds the kernels of that checkout.  The
timing itself is ``tools/kernel_timing.py``, the yardstick of
``chip_smoke.py``: the profiler's device time per call from windows that
count the kernels the wrapper launches, else CUDA events (``ms_by``).

Shapes: the server-GBA bench problem (C=128, P=32,768, K=8), the client's
local-BA problem (C=40, P=4,096, K=16: ``local_ba_max_cams`` and
``local_ba_max_points`` of the config, ``max_obs_per_mp`` of
``rendered_ci_config``) and the GBA stress problem (C=1,024, P=131,072,
K=8).

Prints one JSON line per (kernel, shape): ``kernel_timing.time_table``'s
result (device ms per call, how it was measured, the plain version's ms,
the bound, ``index_add_``'s ms for ``cam_reduce``) with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import kernel_timing as kt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this checkout")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.root).resolve()))

    from ccm_slam_tpu_torch import convert, problems
    from ccm_slam_tpu_torch.ops import ba_kernels as bk

    if not torch.cuda.is_available():
        print("time_ba_kernels: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    shapes = {
        "bench C=128 P=32768 K=8": lambda: problems.make_problem(C=128, P=32768, K=8, device=dev),
        "local BA C=40 P=4096 K=16": lambda: problems.make_problem(C=40, P=4096, K=16, device=dev),
        "stress C=1024 P=131072 K=8": lambda: convert.ba_problem_from_numpy(
            problems.stress_problem_arrays(), dev),
    }
    for shape, make in shapes.items():
        prob = make()
        C, (P, K) = prob.R.shape[0], prob.cam_idx.shape
        table = {"normal_blocks": kt.blocks_entry(bk, prob, bk.cam_csr(prob.cam_idx, C)),
                 "cam_reduce": kt.reduce_entry(bk, prob)}
        for name, res in kt.time_table(table, P * K, f"{a.label} {shape}").items():
            print(json.dumps(dict(code=a.label, kernel=name, shape=shape, card=smi, **res)),
                  flush=True)
        del prob, table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
