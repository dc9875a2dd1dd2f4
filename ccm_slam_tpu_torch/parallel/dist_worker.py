"""One rank of a landmark-sharded GBA run (``parallel.dist_ba``).

Joins a group of ``--world-size`` ranks through a ``FileStore`` at
``--store`` (no port to pick), then runs the tasks of a JSON list in order,
each on every rank:

  {"name": ..., "kind": "solve", "problem": "p.npz", "iters": 10,
   "chunks": 1, "pcg_min_c": null}
      ``dist_ba_solve`` on this rank's shard of a ``BAProblem`` saved as an
      ``.npz`` of its fields, in ``chunks`` equal chunks carrying the state;
  {"name": ..., "kind": "server", "map": "m.npz", "schedule": "chunked" or
   "monolithic", "pcg_min_c": null}
      a ``Server(mesh=...)`` holding one agent's map (``io.checkpoint``'s
      ``.npz``, from either package) seen through the default camera without
      distortion, its two oldest keyframes fixed, solved by ``idle_step``
      chunks of ``CHUNK_ITERS`` or one GBA of ``TOTAL_ITERS``.

Each task writes ``<out-dir>/<name>.rank<r>.npz`` (R, t and this rank's X
for a solve; the map's R_cw, t_cw and pos for a server) and prints one JSON
line: {"event": "dist_done", "task", "rank", "world_size", "backend",
"cost", "branch"} ("dense" or "pcg", as ``CCM_PCG_MIN_C`` stood for the
task).  Collectives time out after ``TIMEOUT_S``.

    python -m ccm_slam_tpu_torch.parallel.dist_worker --store /tmp/s \\
        --world-size 2 --rank 0 --tasks tasks.json --out-dir out --device cpu

The CPU takes gloo; a card (``--device cuda:<r>``) takes NCCL.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..convert import ba_problem_from_numpy
from ..io import checkpoint
from ..ops import bow
from ..runtime.server import Server
from ..solvers import ba
from ..utils.camera import Camera
from . import dist_ba

CHUNK_ITERS, TOTAL_ITERS = 4, 12  # a server task's GBA schedule
TIMEOUT_S = 240.0  # collective timeout


def join_group(store: str, world_size: int, rank: int, device):
    """Initialise the default process group through a FileStore and return
    this rank's mesh."""
    dev = torch.device(device)
    dist.init_process_group(
        dist_ba._backend_for(dev), store=dist.FileStore(store, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist_ba.make_mesh(dev)


def run_solve(task, mesh):
    arr = dict(np.load(task["problem"]))
    prob = dist_ba.shard_problem(ba_problem_from_numpy(arr, mesh.device), mesh)
    chunks = int(task.get("chunks", 1))
    iters = int(task["iters"])
    if iters % chunks:
        raise ValueError(f"{iters} iterations do not split into {chunks} chunks")
    state = None
    for _ in range(chunks):
        R, t, X, cost, state = dist_ba.dist_ba_solve(prob, mesh, iters=iters // chunks,
                                                     state=state, return_state=True)
        prob = prob.replace(R=R, t=t, X=X)
    return cost, {"R": R, "t": t, "X": X}, prob.R.shape[0]


def run_server(task, mesh):
    m = checkpoint.load_map(task["map"], mesh.device)
    K, N = m.kfs.xy.shape[:2]
    cfg = config.SystemConfig(capacity=config.CapacityConfig(
        max_keypoints=N, client_max_kfs=K, client_max_mps=m.mps.capacity, server_max_kfs=K,
        server_max_mps=m.mps.capacity, max_obs_per_mp=m.mps.max_obs))
    cam = Camera.from_config(config.CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), mesh.device)
    vocab = bow.Vocabulary(words=torch.zeros(16, 32, dtype=torch.uint8, device=mesh.device),
                           idf=torch.ones(16, device=mesh.device))
    srv = Server(cfg=cfg, cam=cam, vocab=vocab, n_agents=1, device=mesh.device, mesh=mesh)
    srv.maps[0] = m
    srv.agents[0].last_data_step = 0
    srv.gba_dirty[0] = True
    srv.gba_chunk_iters, srv.gba_total_iters = CHUNK_ITERS, TOTAL_ITERS
    if task.get("schedule", "chunked") == "chunked":
        for _ in range(TOTAL_ITERS // CHUNK_ITERS):
            srv.idle_step()
    else:
        srv._run_gba(0, iters=TOTAL_ITERS)
    out = srv.maps[0]
    return srv.gba_last_cost[0], {"R_cw": out.kfs.R_cw, "t_cw": out.kfs.t_cw,
                                  "pos": out.mps.pos}, K


def run_task(task, mesh, out_dir: Path) -> dict:
    saved = os.environ.get("CCM_PCG_MIN_C")
    if task.get("pcg_min_c") is not None:
        os.environ["CCM_PCG_MIN_C"] = str(task["pcg_min_c"])
    try:
        cost, arrays, C = (run_solve if task["kind"] == "solve" else run_server)(task, mesh)
        branch = "pcg" if C > ba.pcg_min_c() else "dense"
    finally:
        if saved is None:
            os.environ.pop("CCM_PCG_MIN_C", None)
        else:
            os.environ["CCM_PCG_MIN_C"] = saved
    np.savez(out_dir / f"{task['name']}.rank{mesh.rank}.npz",
             **{k: v.detach().cpu().numpy() for k, v in arrays.items()})
    return {"event": "dist_done", "task": task["name"], "rank": mesh.rank,
            "world_size": mesh.world_size, "backend": mesh.backend, "cost": float(cost),
            "branch": branch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True, help="FileStore path shared by the ranks")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--tasks", required=True, help="JSON list of tasks")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", default=None, help="cpu, or cuda:<i> (default cuda:<rank>)")
    args = ap.parse_args(argv)
    device = args.device or f"cuda:{args.rank}"
    mesh = join_group(args.store, args.world_size, args.rank, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        for task in json.loads(Path(args.tasks).read_text()):
            print(json.dumps(run_task(task, mesh, out_dir)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
