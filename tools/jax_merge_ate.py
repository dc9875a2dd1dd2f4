"""The JAX package's two-agent server on the rendered corridor, on the CPU.

    python3 tools/jax_merge_ate.py [--factor 1.0] [--frames 120]

Runs the drive loop of ``tests/test_rendered_merge.py`` with the JAX package:
``rendered_ci_config(factor)`` with ``n_agents=2`` and
``start_map_matching_after_kf=5``; two ``RenderedSequence("corridor",
seed=0, n_frames=120)`` agents over the spans (0, 0.16) and (0.08, 0.24);
the vocabulary ``ccm_slam_tpu/data/vocab32k.npz``; each agent publishes on
every 4th step, every message goes through ``pack_map_msg`` and
``unpack_map_msg`` in both directions, ``idle_step`` runs every step and
then ``quiescence_steps + 2`` more times.  It prints one JSON line: whether
the maps merged, the step and keyframe pair of the merge, frames tracked
per agent, and each agent's keyframe ATE after Sim(3) alignment with the
span it is measured over and the gate of ``tests/test_rendered_merge.py``
(0.02 x span + 0.05), and what ``check_structure`` finds wrong in each
server map (the count and the first few violations).  ``chip_smoke.py``'s ``JAX_MERGE_ATE_M`` comes from
this script's output at ``--factor 1.0``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

from ccm_slam_tpu.config import rendered_ci_config  # noqa: E402
from ccm_slam_tpu.io.rendered import RenderedSequence  # noqa: E402
from ccm_slam_tpu.io.trajectory import ate_rmse, camera_centers  # noqa: E402
from ccm_slam_tpu.models.map_store import check_structure  # noqa: E402
from ccm_slam_tpu.ops import bow  # noqa: E402
from ccm_slam_tpu.runtime import communicator as comm  # noqa: E402
from ccm_slam_tpu.runtime import map_matching as jmm  # noqa: E402
from ccm_slam_tpu.runtime.server import Server  # noqa: E402
from ccm_slam_tpu.runtime.tracker import Tracker  # noqa: E402
from ccm_slam_tpu.runtime.wire import pack_map_msg, unpack_map_msg  # noqa: E402
from ccm_slam_tpu.utils.camera import Camera  # noqa: E402

SPANS = ((0.0, 0.16), (0.08, 0.24))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--factor", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    cfg = rendered_ci_config(factor=args.factor)
    cfg = cfg.replace(n_agents=2, placerec=dataclasses.replace(
        cfg.placerec, start_map_matching_after_kf=5))
    cam = Camera.from_config(cfg.camera)
    n = args.frames
    seqs = [RenderedSequence(world="corridor", seed=0, n_frames=n, span=sp, cam=cfg.camera)
            for sp in SPANS]
    vocab = bow.load_vocabulary(str(ROOT / "ccm_slam_tpu" / "data" / "vocab32k.npz"))
    server = Server(cfg=cfg, cam=cam, vocab=vocab, n_agents=2)
    trackers = [Tracker(cfg=cfg, cam=cam, client_id=i) for i in range(2)]
    states = [comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                          cfg.capacity.client_max_mps) for _ in range(2)]

    pair = {}
    correct_loop = jmm.correct_loop

    def recording_correct_loop(m, kf_q, kf_c, *a, **kw):
        ids, cl = np.asarray(m.kfs.kf_id), np.asarray(m.kfs.client_id)
        pair["query"] = [int(cl[int(kf_q)]), int(ids[int(kf_q)])]
        pair["match"] = [int(cl[int(kf_c)]), int(ids[int(kf_c)])]
        return correct_loop(m, kf_q, kf_c, *a, **kw)

    jmm.correct_loop = recording_correct_loop
    iters = [s.frames() for s in seqs]
    tracked = [0, 0]
    merge_step = None
    t0 = time.perf_counter()
    for step in range(n):
        for i in (0, 1):
            try:
                fr = next(iters[i])
            except StopIteration:
                continue
            if trackers[i].process_image(jnp.asarray(fr.image), fr.timestamp) is not None:
                tracked[i] += 1
            if trackers[i].map is None or step % 4 != 3:
                continue
            msg, states[i] = comm.publish_client(
                trackers[i].map, states[i], i, max_kfs=cfg.comm.client_pub_max_kfs,
                max_mps=cfg.comm.client_pub_max_mps)
            if msg.empty:
                continue
            msg = unpack_map_msg(pack_map_msg(msg))
            new_ids = [int(k) for k, v in zip(np.asarray(msg.kfs.kf_id),
                                              np.asarray(msg.kfs.valid)) if v]
            ack = unpack_map_msg(pack_map_msg(server.ingest(i, msg)))
            states[i] = comm.apply_server_acks(states[i], trackers[i].map, ack)
            ag = server.agents[i]
            for kf_id in new_ids:
                if kf_id in ag.kf_table:
                    _, merged = server.mapping_step(i, ag.kf_table[kf_id])
                    if merged and merge_step is None:
                        merge_step = step
        server.idle_step()
        if step % 10 == 0:
            print(f"step {step}: tracked {tracked}, merged at {merge_step}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    for _ in range(server.quiescence_steps + 2):
        server.idle_step()
    out = dict(factor=args.factor, frames=n, tracked=tracked, merged=merge_step is not None,
               merge_step=merge_step, merge_pair=pair,
               shared_slot=server.agents[0].map_slot == server.agents[1].map_slot)
    for i in (0, 1):
        ts, R, t = server.trajectory(i)
        est = np.asarray(camera_centers(jnp.asarray(R), jnp.asarray(t)))
        gt_ts, gt_pos, _ = seqs[i].ground_truth()
        gt = gt_pos[np.clip(np.searchsorted(gt_ts, np.asarray(ts)), 0, len(gt_ts) - 1)]
        rmse, _ = ate_rmse(est, gt, align="sim3")
        span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
        out[f"agent{i}"] = dict(keyframes=int(len(ts)), ate_m=float(rmse), span_m=span,
                                gate_m=0.02 * span + 0.05)
    for slot, m in server.maps.items():
        bad = check_structure(m)
        out[f"check_structure_map{slot}"] = dict(violations=len(bad), first=bad[:5])
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
