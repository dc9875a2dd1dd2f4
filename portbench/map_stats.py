"""The shape of the map that the client cell builds, on the card.

    python3 portbench/map_stats.py --workload client.corridor --seed 1 --frames 400

Sets up the cell as a run does, feeds ``--frames`` more frames and prints
one JSON line: the map's live keyframes and landmarks, observations per
landmark (mean and histogram), per keyframe and by octave, and the span of
each landmark's observers in keyframes (``cells.client.map_stats``), with
the tracker's counts.  The server maps of ``gen.gba_maps`` take their
shape from these readings.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.cells import client  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="client.corridor")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=400)
    args = ap.parse_args()
    root = os.path.dirname(harness.BENCH)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    _, config, traffic, _, _ = harness.cell_spec(harness.load_manifest(root), root, args.workload)
    t0 = time.perf_counter()
    cell = client.Cell(config, traffic, args.seed, dev, root)
    for _ in range(args.frames):
        cell.step()
    out = dict(workload=args.workload, seed=args.seed, frames=cell.s,
               seconds=time.perf_counter() - t0,
               lost=sum(e is None for e in cell.tracker.trajectory),
               tracker={k: v for k, v in cell.tracker.stats.items()
                        if isinstance(v, (int, float))},
               map=client.map_stats(cell.tracker.map))
    cell.release()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
