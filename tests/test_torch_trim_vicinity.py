"""Bounded client map and server vicinity feedback, end to end on the port:
tests/test_trim_vicinity.py's drive and gates with the port's ``Tracker``
(``enable_trimming`` gated by ``communicator.trimmable_mask``, relocalization
on), ``Server`` and communicator, on the synthetic arc of
tests/test_torch_client.py walked out (60 frames) and back (55).  The client
publishes every 4th frame; with feedback the server's vicinity (8 keyframes
around the agent's reported closest keyframe) is ingested every 6th.

Gates (tests/test_trim_vicinity.py's): trimming fires and keeps the own
alive keyframes within LocalMapSize + LocalMapBuffer + 4; the server keeps
every keyframe but the last window; fed keyframes arrive, stay alive and
share landmarks with the agent's own; with feedback the revisit tracks at
least 90% of the frames and inliers of the run without it, and >= 75% of
the return frames in all.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ccm_slam_tpu_torch.config import CameraConfig, MappingConfig, TrackingConfig
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.ops import bow
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime.server import Server
from ccm_slam_tpu_torch.runtime.tracker import OK, Tracker
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_torch_client import make_trajectory, make_world, render_frame, small_config

N_OUT, N_BACK = 60, 55


def drive(vicinity: int, seed=11):
    cfg = small_config()
    cfg = cfg.replace(
        mapping=MappingConfig(local_map_size=8, local_map_buffer=4, second_fuse_pass=False),
        tracking=TrackingConfig(min_frames=3, th_ref_ratio=0.98))
    if vicinity:
        cfg = cfg.replace(comm=dataclasses.replace(cfg.comm, server_kfs_to_client=vicinity))
    cam = Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")
    points, desc_w = make_world(seed)
    fwd = make_trajectory(N_OUT)
    poses = fwd + fwd[::-1][1:N_BACK + 1]
    rng = np.random.RandomState(7)
    vocab = bow.train_vocabulary(torch.as_tensor(desc_w),
                                 torch.ones(len(desc_w), dtype=torch.bool), n_words=128, iters=4,
                                 generator=torch.Generator().manual_seed(0))
    server = Server(cfg=cfg, cam=cam, vocab=vocab, n_agents=1, device="cpu")
    holder = {"st": comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                                cfg.capacity.client_max_mps)}
    tracker = Tracker(cfg=cfg, cam=cam, client_id=0, device="cpu", enable_trimming=True,
                      enable_relocalization=True,
                      trim_mask_fn=lambda m: comm.trimmable_mask(m, holder["st"]))
    foreign_kf, foreign_mp = {}, {}
    reset_epoch = max_alive_own = return_tracked = n_return = 0
    return_inliers = []
    for i, T in enumerate(poses):
        out = tracker.process_frame(render_frame(points, desc_w, T, cam, rng, i * 0.05))
        if i >= N_OUT + 10:  # well into revisited ground
            n_return += 1
            if out is not None:
                return_tracked += 1
                return_inliers.append(tracker.stats.get("last_inliers", 0))
        if tracker.reset_epoch != reset_epoch:
            reset_epoch = tracker.reset_epoch
            holder["st"] = comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                                       cfg.capacity.client_max_mps)
            foreign_kf.clear()
            foreign_mp.clear()
            server.reset_agent(0)
        if tracker.map is None:
            continue
        if tracker.last_compaction is not None:
            kf_r, mp_r = (np.asarray(r) for r in tracker.last_compaction)
            tracker.last_compaction = None
            holder["st"] = comm.remap_client_state(holder["st"], kf_r, mp_r)
            foreign_kf = {k: int(kf_r[v]) for k, v in foreign_kf.items() if kf_r[v] >= 0}
            foreign_mp = {k: int(mp_r[v]) for k, v in foreign_mp.items() if mp_r[v] >= 0}
        kfs = tracker.map.kfs
        alive = (kfs.valid & ~kfs.bad).numpy()
        own_alive = int((alive & (kfs.client_id.numpy() == 0)).sum())
        own_alive -= int((alive & holder["st"].kf_from_server).sum())
        max_alive_own = max(max_alive_own, own_alive)
        if i % 4 == 0:
            closest = int(kfs.kf_id[tracker.ref_kf])
            msg, holder["st"] = comm.publish_client(tracker.map, holder["st"], 0, max_kfs=8,
                                                    max_mps=600, current_kf_id=closest)
            if not msg.empty:
                new_ids = [int(k) for k, v in zip(msg.kfs.kf_id.numpy(), msg.kfs.valid.numpy())
                           if v]
                ack = server.ingest(0, msg)
                holder["st"] = comm.apply_server_acks(holder["st"], tracker.map, ack)
                ag = server.agents[0]
                for kf_id in new_ids:
                    if kf_id in ag.kf_table:
                        server.mapping_step(0, ag.kf_table[kf_id])
        if cfg.comm.server_kfs_to_client > 0 and i % 6 == 0 and i > 0:
            vic = server.pack_vicinity(0)
            if vic.kfs is not None:
                tracker.map = comm.ingest_server_map(tracker.map, vic, 0, foreign_kf, foreign_mp,
                                                     comm_state=holder["st"])
    m, st = tracker.map, holder["st"]
    W = ms.covisibility_matrix(m).numpy()
    alive = (m.kfs.valid & ~m.kfs.bad).numpy()
    fed, own = st.kf_from_server & alive, ~st.kf_from_server & alive
    return dict(tracker=tracker, st=st,
                fed_connected=bool(fed.any() and own.any() and (W[fed][:, own] > 0).any()),
                max_alive_own=max_alive_own, return_tracked=return_tracked, n_return=n_return,
                mean_return_inliers=float(np.mean(return_inliers)) if return_inliers else 0.0,
                kf_created=tracker.stats["kf_created"],
                kf_trimmed=tracker.stats.get("kf_trimmed", 0),
                server_kfs=len(server.agents[0].kf_table))


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        yield drive(vicinity=8), drive(vicinity=0)
    finally:
        torch.set_num_threads(n)


def test_trimming_fires_and_bounds_the_arena(runs):
    r = runs[1]
    bound = 8 + 4  # LocalMapSize + LocalMapBuffer
    assert r["kf_created"] > bound, r
    assert r["kf_trimmed"] > 0, "trimming never fired"
    assert r["max_alive_own"] <= bound + 4, r["max_alive_own"]


def test_server_keeps_everything(runs):
    r = runs[1]
    assert r["server_kfs"] >= r["kf_created"] - 4, r


def test_feedback_entities_arrive_and_are_woven_in(runs):
    r = runs[0]
    st, m = r["st"], r["tracker"].map
    alive = (m.kfs.valid & ~m.kfs.bad).numpy()
    assert (alive & st.kf_from_server).sum() > 0
    assert r["fed_connected"], "fed keyframes have no covisibility links"


def test_revisit_no_worse_with_feedback(runs):
    rv, rc = runs
    assert rv["return_tracked"] >= 0.9 * rc["return_tracked"], (rv, rc)
    assert rv["mean_return_inliers"] >= 0.9 * rc["mean_return_inliers"]
    assert rv["tracker"].state == OK
    assert rv["return_tracked"] >= 0.75 * rv["n_return"], rv
