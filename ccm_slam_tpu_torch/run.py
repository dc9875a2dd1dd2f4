"""Run the system on EuRoC, KITTI or rendered sequences: the replacement for
the reference's ROS launch files (Server.launch + Client<i>_euroc.launch +
rosbag play), on the card unless ``--cpu`` asks for the CPU.

Counterpart of ``scripts/run_euroc.py``, with the same flags and outputs.

Single agent:
  python -m ccm_slam_tpu_torch.run --seq /data/MH_01_easy --out out/

KITTI odometry (reference conf/kitti_mono.yaml + launch/KITTI):
  python -m ccm_slam_tpu_torch.run --dataset kitti --seq /data/kitti:07 --out out/

Rendered pixels (no download; spec ``<world>:<seed>[:n_frames[:lo-hi]]``):
  python -m ccm_slam_tpu_torch.run --dataset rendered --seq corridor:0:120 --server

Multi-agent centralized, staggered starts as readme.md:152:
  python -m ccm_slam_tpu_torch.run --seq /data/MH_01_easy /data/MH_02_easy \\
      --starts 45 35 --out out/

Outputs per agent: KF_GBA_<agent>.csv (TUM or EuRoC format, the reference's
trajectory product); per map: map_<slot>.npz checkpoint, map_<slot>.ply
cloud and scene_<slot>.json.  With ground truth it prints the keyframe ATE
RMSE (evo_ape protocol: Sim3 alignment).  ``CCM_RENDER_CACHE`` names a
directory that keeps rendered frames between runs.

``main(argv)`` runs in-process and returns 0; ``main(argv, state)`` also
fills the dict ``state`` with the run's trackers, server and sequences, and
each round's tracking wall per frame (``frame_walls``, seconds: CUDA events
on the card, so the loop gains no sync; the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import sys
import threading
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ccm_slam_tpu_torch.run")
    ap.add_argument("--seq", nargs="+", required=True,
                    help="EuRoC roots (mav0/ inside); for --dataset kitti use <root>:<seq>")
    ap.add_argument("--dataset", default="euroc", choices=["euroc", "kitti", "rendered"])
    ap.add_argument("--factor", type=float, default=1.0,
                    help="rendered dataset resolution factor (1.0 = 752x480)")
    ap.add_argument("--starts", nargs="*", type=float, default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--limit", type=int, default=None, help="max frames per agent")
    ap.add_argument("--vocab", default=None, help="pretrained vocabulary npz")
    ap.add_argument("--native-loader", action="store_true",
                    help="accepted for the reference's command lines; not read")
    ap.add_argument("--batch-frontend", action="store_true",
                    help="accepted for the reference's command lines; the agents' "
                         "frames are tracked one after another either way")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda:0)")
    ap.add_argument("--server", action="store_true",
                    help="run the central server even for a single agent "
                         "(loop closing + GBA)")
    ap.add_argument("--vicinity", type=int, default=None, metavar="N",
                    help="server->client feedback budget: up to N vicinity "
                         "keyframes per server publish cycle (reference "
                         "Comm.Server.KfsToClient; default from config, 0=off)")
    ap.add_argument("--trim", action="store_true",
                    help="bound the client map at Mapping.LocalMapSize "
                         "keyframes, trimming only sent+acked entities "
                         "(Map::MapTrimming; requires --server)")
    ap.add_argument("--reloc", action="store_true",
                    help="arm PnP relocalization after tracking loss")
    ap.add_argument("--mm-window", type=float, default=None,
                    help="widened motion-model retry factor (Tracking.mm_retry_window)")
    ap.add_argument("--traj-format", default="tum", choices=["tum", "euroc"],
                    help="trajectory output format (reference Stats.trajectory_format)")
    ap.add_argument("--show-params", action="store_true",
                    help="dump the parameter tree at startup (params::ShowParams)")
    ap.add_argument("--progress", type=int, default=50, metavar="N",
                    help="print a tracking status line every N frames (0=off)")
    ap.add_argument("--live-viewer", type=int, default=None, metavar="PORT",
                    help="stream the live scene + annotated camera frame at "
                         "http://127.0.0.1:PORT/ (0 picks a free port)")
    return ap.parse_args(argv)


def sequences(args, device):
    """(config, [sequence per agent]) for ``args.dataset`` and ``args.seq``."""
    from .config import DEFAULT_CONFIG, KITTI_CAMERA, rendered_ci_config
    from .io import euroc

    cfg = DEFAULT_CONFIG
    if args.dataset == "kitti":
        from .io.kitti import KittiSequence

        seqs = []
        for spec in args.seq:
            root, _, nn = spec.rpartition(":")
            seqs.append(KittiSequence(root=root or spec, seq=nn or "00"))
        cfg = cfg.replace(camera=KITTI_CAMERA)
    elif args.dataset == "rendered":
        # spec = <world>:<seed>[:n_frames[:span_lo-span_hi]], e.g. corridor:0
        # or loop:0:400:0-1; rendered on the run's device
        from .io.rendered import RenderedSequence

        cfg = rendered_ci_config(factor=args.factor)
        seqs = []
        for spec in args.seq:
            parts = spec.split(":")
            world = parts[0] or "corridor"
            seed = int(parts[1]) if len(parts) > 1 else 0
            n_frames = int(parts[2]) if len(parts) > 2 else (args.limit or 300)
            span = (0.0, 1.0)
            if len(parts) > 3:
                lo, _, hi = parts[3].partition("-")
                span = (float(lo), float(hi or 1.0))
            seqs.append(RenderedSequence(
                world=world, seed=seed, n_frames=n_frames, span=span, cam=cfg.camera,
                backend="torch", device=device,
                cache_dir=os.environ.get("CCM_RENDER_CACHE") or None))
    else:
        seqs = [euroc.EurocSequence(root=r) for r in args.seq]
    if args.vicinity is not None:
        cfg = cfg.replace(comm=dataclasses.replace(cfg.comm, server_kfs_to_client=args.vicinity))
    if args.mm_window is not None:
        cfg = cfg.replace(
            tracking=dataclasses.replace(cfg.tracking, mm_retry_window=args.mm_window))
    return cfg, seqs


def bootstrap_vocabulary(image, device):
    """The vocabulary trained on one frame's descriptors (1,024 words, 6
    iterations), its centroid seeds drawn by a ``torch.Generator`` seeded 0
    (the reference draws them from ``PRNGKey(0)``)."""
    from .ops import bow, orb

    feats = orb.extract(torch.as_tensor(image, dtype=torch.float32, device=device))
    gen = torch.Generator(device=device).manual_seed(0)
    return bow.train_vocabulary(feats.desc, feats.valid, n_words=1024, iters=6, generator=gen)


class _ViewerFeed:
    """Publishes to a LiveViewer from a worker thread, so the viewer never
    stalls the loop; a full queue drops the offer (latest wins).  Offers are
    host copies taken on the caller's thread."""

    def __init__(self, viewer):
        self.viewer = viewer
        self.q: queue.Queue = queue.Queue(maxsize=2)
        threading.Thread(target=self._work, daemon=True, name="viewer-pub").start()

    def _work(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            kind, payload = item
            try:
                if kind == "map":
                    self.viewer.publish_map(payload)
                else:
                    self.viewer.publish_frame(*payload)
            except Exception as e:  # the viewer must never kill the run
                print(f"[viewer] publish failed: {e}")

    def offer(self, kind, payload):
        try:
            self.q.put_nowait((kind, payload))
        except queue.Full:
            pass


def _stamp(device):
    """A point on the run's clock that costs no sync: a recorded CUDA event
    on the card, the host clock on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(a, b) -> float:
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def _alive_kf_count(m) -> int:
    return 0 if m is None else int(torch.sum(m.kfs.valid & ~m.kfs.bad))


def run(args, state=None) -> int:
    from . import config
    from .device import resolve_device
    from .io import checkpoint as ckpt
    from .io import euroc, export
    from .io.trajectory import ate_rmse, camera_centers, write_euroc, write_tum
    from .runtime import communicator as comm
    from .runtime.server import Server
    from .runtime.tracker import Tracker
    from .utils.camera import Camera

    device = torch.device("cpu") if args.cpu else resolve_device(None)
    os.makedirs(args.out, exist_ok=True)
    cfg, seqs = sequences(args, device)
    if args.show_params:
        config.show_params(cfg, file=sys.stdout)
    n_agents = len(args.seq)
    starts = args.starts or [0.0] * n_agents
    cam = Camera.from_config(cfg.camera, device)
    trackers = [Tracker(cfg=cfg, cam=cam, client_id=i, device=device) for i in range(n_agents)]
    if args.reloc:
        for tr in trackers:
            tr.enable_relocalization = True

    server = None
    comm_states = None
    if n_agents > 1 or args.server:
        if args.vocab:
            vocab = ckpt.load_vocabulary(args.vocab, device)
        else:
            f0 = next(seqs[0].frames(start=starts[0], limit=1))
            vocab = bootstrap_vocabulary(f0.image, device)
        server = Server(cfg=cfg, cam=cam, vocab=vocab, n_agents=n_agents, device=device)
        comm_states = [comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                                   cfg.capacity.client_max_mps)
                       for _ in range(n_agents)]
        # client-side tables of server-fed (vicinity) entities
        foreign_kf = [dict() for _ in range(n_agents)]
        foreign_mp = [dict() for _ in range(n_agents)]
        reset_epochs = [0] * n_agents
        if args.trim:
            # bounded client map: trim only sent+acked (CanBeForgotten)
            for i, tr in enumerate(trackers):
                tr.enable_trimming = True
                tr.trim_mask_fn = lambda m, _i=i: comm.trimmable_mask(m, comm_states[_i])
    if state is not None:
        state.update(trackers=trackers, server=server, seqs=seqs, cfg=cfg)
    stamps = []  # (start, end, frames) of each round's tracking

    viewer = feed = None
    if args.live_viewer is not None:
        from .io.live_viewer import LiveViewer, host_copy

        viewer = LiveViewer(port=args.live_viewer)
        feed = _ViewerFeed(viewer)
        print(f"live viewer: {viewer.url}")

    iters = [iter(s.frames(start=st, limit=args.limit)) for s, st in zip(seqs, starts)]
    live = [True] * n_agents
    frame_count = [0] * n_agents
    last_lost = [0] * n_agents
    pub_every = max(1, int(cfg.camera.fps / cfg.comm.client_pub_freq))
    srv_every = max(1, int(cfg.camera.fps / cfg.comm.server_pub_freq))

    while any(live):
        pending = []
        for i in range(n_agents):
            if not live[i]:
                continue
            try:
                fr = next(iters[i])
            except StopIteration:
                live[i] = False
                continue
            pending.append((i, fr))
        t_frames = _stamp(device) if state is not None else None
        for i, fr in pending:
            trackers[i].process_image(fr.image, fr.timestamp)
        if pending and state is not None:
            stamps.append((t_frames, _stamp(device), len(pending)))
        processed = {i for i, _ in pending}
        for i in processed:
            frame_count[i] += 1
        for i in sorted(processed):
            tr = trackers[i]
            if args.progress and (frame_count[i] % args.progress == 0
                                  or tr.n_lost_frames != last_lost[i]):
                last_lost[i] = tr.n_lost_frames
                s = tr.stats
                # the reloc_n_match / reloc_pnp_in / reloc_lm_in keys are never
                # written, so they print None, as in the reference
                print(f"[agent {i}] frame {frame_count[i]} state={tr.state} "
                      f"kfs={_alive_kf_count(tr.map)} lost={tr.n_lost_frames} "
                      f"path={s.get('path')} "
                      f"mm={s.get('mm_n_match')}/{s.get('mm_n_in')} "
                      f"ref={s.get('ref_n_match')}/{s.get('ref_n_in')} "
                      f"lm={s.get('lm_n_in_a')} "
                      f"reloc={s.get('reloc_fail')},{s.get('reloc_n_match')},"
                      f"{s.get('reloc_pnp_in')},{s.get('reloc_lm_in')}", flush=True)
            if server is None:
                continue
            # reset-while-connected: the client restarted ids at 0, so every
            # arena-aligned table is resynchronised on both ends
            if tr.reset_epoch != reset_epochs[i]:
                reset_epochs[i] = tr.reset_epoch
                comm_states[i] = comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                                             cfg.capacity.client_max_mps)
                foreign_kf[i].clear()
                foreign_mp[i].clear()
                server.reset_agent(i)
            if tr.map is None:
                continue
            # the client arena's compaction permuted slots: remap the comm
            # state and the foreign-entity tables
            if tr.last_compaction is not None:
                kf_r, mp_r = (np.asarray(r) for r in tr.last_compaction)
                tr.last_compaction = None
                comm_states[i] = comm.remap_client_state(comm_states[i], kf_r, mp_r)
                foreign_kf[i] = {key: int(kf_r[v]) for key, v in foreign_kf[i].items()
                                 if kf_r[v] >= 0}
                foreign_mp[i] = {key: int(mp_r[v]) for key, v in foreign_mp[i].items()
                                 if mp_r[v] >= 0}
            if frame_count[i] % pub_every == 0:
                closest = int(tr.map.kfs.kf_id[tr.ref_kf])
                msg, comm_states[i] = comm.publish_client(
                    tr.map, comm_states[i], i, max_kfs=cfg.comm.client_pub_max_kfs,
                    max_mps=cfg.comm.client_pub_max_mps, current_kf_id=closest)
                if not msg.empty:
                    new_ids = [int(k) for k, v in zip(msg.kfs.kf_id.cpu().numpy(),
                                                      msg.kfs.valid.cpu().numpy()) if v]
                    ack = server.ingest(i, msg)
                    comm_states[i] = comm.apply_server_acks(comm_states[i], tr.map, ack)
                    ag = server.agents[i]
                    for kf_id in new_ids:
                        if kf_id in ag.kf_table:
                            server.mapping_step(i, ag.kf_table[kf_id])
            # server->client vicinity feedback at the server publish rate
            if cfg.comm.server_kfs_to_client > 0 and frame_count[i] % srv_every == 0:
                vic = server.pack_vicinity(i)
                if vic.kfs is not None:
                    tr.map = comm.ingest_server_map(tr.map, vic, i, foreign_kf[i],
                                                    foreign_mp[i], comm_state=comm_states[i])
        if server is not None:
            server.idle_step()
        if feed is not None and 0 in processed and frame_count[0] % pub_every == 0:
            if trackers[0].map is not None:
                m0 = (server.maps[server.agents[0].map_slot] if server is not None
                      else trackers[0].map)
                feed.offer("map", host_copy(m0))
            raw0 = next((fr for i, fr in pending if i == 0), None)
            if raw0 is not None and trackers[0].last_frame is not None:
                feed.offer("frame", (host_copy(torch.as_tensor(raw0.image)),
                                     host_copy(trackers[0].last_frame)))

    # final GBA on quiescence
    if server is not None:
        for _ in range(server.quiescence_steps + 2):
            server.idle_step()

    if viewer is not None and trackers[0].map is not None:  # the final (post-GBA) scene
        m0 = server.maps[server.agents[0].map_slot] if server is not None else trackers[0].map
        viewer.publish_map(host_copy(m0))

    if state is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        state["frame_walls"] = [_seconds(a, b) / n for a, b, n in stamps]

    # outputs
    t_sc = np.asarray(cfg.camera.t_sc)
    writer = write_euroc if args.traj_format == "euroc" else write_tum
    for i in range(n_agents):
        if server is not None:
            ts, R, t = server.trajectory(i)
        else:
            m = trackers[i].map
            if m is None:
                print(f"agent {i}: no map")
                continue
            alive = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
            idxs = np.where(alive)[0]
            idxs = idxs[np.argsort(m.kfs.kf_id.cpu().numpy()[idxs])]
            ts = m.kfs.timestamp.cpu().numpy()[idxs]
            R = m.kfs.R_cw.cpu().numpy()[idxs]
            t = m.kfs.t_cw.cpu().numpy()[idxs]
        path = os.path.join(args.out, f"KF_GBA_{i}.csv")
        writer(path, ts, R, t, t_sc=t_sc)
        print(f"agent {i}: {len(ts)} keyframes -> {path}")

        # ATE against ground truth when available
        try:
            gt_ts, gt_pos, _ = seqs[i].ground_truth()
            mask, gt_match = euroc.associate_gt(ts, gt_ts, gt_pos)
            if mask.sum() >= 3:
                est_pos = camera_centers(torch.as_tensor(R), torch.as_tensor(t)).numpy()
                rmse, _ = ate_rmse(est_pos[mask], gt_match[mask])
                print(f"agent {i}: ATE RMSE (Sim3) = {rmse:.4f} m over {mask.sum()} KFs")
        except FileNotFoundError:
            pass

    # map artifacts
    if server is not None:
        for slot, m in server.maps.items():
            if int(torch.sum(m.kfs.valid)) == 0:
                continue
            ckpt.save_map(os.path.join(args.out, f"map_{slot}.npz"), m)
            export.export_pointcloud_ply(os.path.join(args.out, f"map_{slot}.ply"), m)
            export.export_scene_json(os.path.join(args.out, f"scene_{slot}.json"), m)
    elif trackers[0].map is not None:
        ckpt.save_map(os.path.join(args.out, "map_0.npz"), trackers[0].map)
        export.export_pointcloud_ply(os.path.join(args.out, "map_0.ply"), trackers[0].map)
        export.export_scene_json(os.path.join(args.out, "scene_0.json"), trackers[0].map)

    if viewer is not None:
        feed.q.put(None)
        if sys.stdin.isatty():
            print(f"live viewer still serving at {viewer.url} -- Ctrl-C to exit")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass
        viewer.close()
    return 0


def main(argv=None, state=None) -> int:
    return run(parse_args(argv), state)


if __name__ == "__main__":
    sys.exit(main())
