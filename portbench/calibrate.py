"""The readings that the check limits are set from, on the card.

    python3 portbench/calibrate.py --workload gba.fused4 --seeds 1-12 \
        --control-seeds 1-3 [--faults NAME,...] [--fault-seeds 1-3] \
        --seconds 2 [--out readings.jsonl]

For each seed, one run of the cell (set-up, a short window, the check) as
``run.py`` makes it, with every limit lifted: the program's readings.  For
each control seed, the same run with the cell module's ``control`` applied
after set-up: the control, one precision below the configuration's (each
cell module says which).  For each fault of the cell module's ``FAULTS``
named and each fault seed, the same run with that fault planted under the
timed path once set-up is over.  One JSON line per run: the seed, the
kind, each compared number, the end-to-end metrics and the cell's
counters over the window (CG steps, keyframes); the limits go in the
traffic files from them.
"""

import importlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness, trace  # noqa: E402


def _seeds(text):
    out = []
    for part in (text or "").split(","):
        if part:
            a, _, b = part.partition("-")
            out += list(range(int(a), int(b or a) + 1))
    return out


def _switched(make, on):
    """A ``Patches.wrap`` maker: the function until ``on[0]`` is set, then
    the broken one ``make`` makes of it."""
    def wrap(fn):
        broken = make(fn)

        def call(*a, **kw):
            return (broken if on[0] else fn)(*a, **kw)
        return call
    return wrap


def run(root, manifest, workload, seed, seconds, dev, kind="program"):
    """(result dict, compared rows, window counters) of one run of
    ``kind``: "program", "control" or the name of a fault."""
    _, _, traffic, _, _ = harness.cell_spec(manifest, root, workload)
    cells = importlib.import_module(f"portbench.cells.{traffic['kind']}")
    on, patches, got = [False], trace.Patches(), {}
    if kind not in ("program", "control"):
        module, attr, make = cells.FAULTS[kind]
        patches.wrap(module, attr, _switched(make, on))

    def prepare(cell):
        on[0] = True
        if kind == "control":
            cells.control(cell)
        cell.reset_counters()
        check = cell.check

        def counted_check():
            got.update(cell.counters())
            return check()
        cell.check = counted_check

    try:
        out, rows = harness.run_cell(root, workload, seed, seconds, False, dev,
                                     manifest=manifest, prepare=prepare)
    finally:
        patches.restore()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return out, rows, got


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="1-3")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.dirname(harness.BENCH)
    manifest = harness.load_manifest(root)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    sink = open(args.out, "a") if args.out else None
    runs = [(s, "program") for s in _seeds(args.seeds)]
    runs += [(s, "control") for s in _seeds(args.control_seeds)]
    runs += [(s, f) for f in args.faults.split(",") if f for s in _seeds(args.fault_seeds)]
    for seed, kind in runs:
        t = time.perf_counter()
        out, rows, counters = run(root, manifest, args.workload, seed, args.seconds, dev, kind)
        line = json.dumps(dict(workload=args.workload, seed=seed, kind=kind,
                               failed=out["failed"], attempted=out["attempted"],
                               metrics={k: v["value"] for k, v in out["metrics"].items()},
                               readings={k: v for k, v, _ in rows},
                               counters={k: v for k, v in counters.items()
                                         if isinstance(v, (int, float))},
                               seconds=time.perf_counter() - t))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
