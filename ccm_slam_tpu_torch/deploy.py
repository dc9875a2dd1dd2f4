"""Multi-process centralized deployment over the native TCP channel.

Counterpart of ``scripts/run_multiprocess.py``, with the same subcommands,
flags and JSON event lines.  The reference deploys as one server process and
N <= 4 client processes, possibly on different machines, glued by ROS topics
(readme.md:172-177, Server.launch + Client<i>_euroc.launch).  Here the
framed-TCP ``NativeChannel`` replaces the ROS topic pair, the delta/ack
communicator is the reliability layer, and the server process owns the maps,
place recognition, merges and GBA.  Messages are wire-packed
(``runtime/wire.py``); vicinity feedback rides the ack.  Every process runs
on ``cuda:0`` unless ``--cpu`` asks for the CPU.

Single-host smoke (starts the server and N clients as fresh interpreters):
  python -m ccm_slam_tpu_torch.deploy launch --agents 2 --out out_mp

Multi-host (one command per host):
  host A:  python -m ccm_slam_tpu_torch.deploy server --port 7800 --agents 2 --out out/
  host B:  python -m ccm_slam_tpu_torch.deploy client --agent 0 --connect hostA:7800
  host C:  python -m ccm_slam_tpu_torch.deploy client --agent 1 --connect hostA:7800

Clients stream either a synthetic corridor (default; a deterministic world
shared through --world-seed) or a sequence (--seq rendered:<world>:<seed>:
<n_frames>[:<lo>-<hi>] or an EuRoC root; the full tracker).  The server
writes KF_GBA_<agent>.csv per agent (TUM) and prints a run summary.  The
server's receive threads only receive; all device work runs on its main
thread.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[1]


def _event(**kw):
    print(json.dumps(kw), flush=True)


def _common_setup(cpu: bool, args=None) -> torch.device:
    """The process's device, and with ``--coordinator`` the default process
    group that the sharded GBA spans (TCP init at host:port).  Every kernel
    launch count starts at 0 here: the process's closing event reports them."""
    from .device import resolve_device
    from .ops import ba_kernels, hamming_kernels

    ba_kernels.reset_launch_counts()
    hamming_kernels.reset_launch_counts()
    device = torch.device("cpu") if cpu else resolve_device(None)
    if args is not None and getattr(args, "coordinator", None):
        import torch.distributed as dist

        from .parallel import dist_ba

        dist.init_process_group(dist_ba._backend_for(device),
                                init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_processes, rank=args.process_id)
    return device


def _build_cfg(n_feat):
    from .config import CapacityConfig, PlaceRecConfig, SystemConfig

    return SystemConfig(
        capacity=CapacityConfig(
            max_keypoints=n_feat,
            client_max_kfs=16,
            client_max_mps=1024,
            server_max_kfs=64,
            server_max_mps=4096,
            max_obs_per_mp=8,
        ),
        placerec=PlaceRecConfig(start_map_matching_after_kf=0),
    )


def _camera(device):
    from .config import CameraConfig
    from .utils.camera import Camera

    return Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), device)


def _wire_pack(msg):
    """MapMsg -> quantized wire bytes (``runtime/wire.py``)."""
    from .runtime import wire

    return None if msg is None else wire.pack_map_msg(msg)


def _wire_unpack(b, device):
    from .runtime import wire

    return wire.unpack_map_msg(b, device) if isinstance(b, bytes) else b


def _vocab(world_seed: int, device):
    """256 words trained on the synthetic world's descriptors, the centroid
    seeds drawn by a ``torch.Generator`` seeded 0."""
    from .io.synthetic import make_world
    from .ops import bow

    _, wdesc = make_world(np.random.RandomState(world_seed), n=300)
    gen = torch.Generator(device=device).manual_seed(0)
    return bow.train_vocabulary(torch.as_tensor(wdesc, device=device),
                                torch.ones(len(wdesc), dtype=torch.bool, device=device),
                                n_words=256, iters=6, generator=gen)


def _recv_ack(ch):
    reply = ch.recv()
    if not isinstance(reply, dict) or reply.get("type") != "ack":
        raise ConnectionError(f"expected an ack from the server, got {reply!r:.200}")
    return reply


def _launches() -> dict:
    """The process's kernel launches so far, by kernel."""
    from .ops import ba_kernels, hamming_kernels

    return {**ba_kernels.launch_counts(), **hamming_kernels.launch_counts()}


def _own_alive(m, agent):
    kfs = m.kfs
    return ((kfs.valid & ~kfs.bad) & (kfs.client_id == agent)).cpu().numpy()


# ----------------------------------------------------------------- server ----


def run_server(args):
    device = _common_setup(args.cpu, args)
    import dataclasses

    from .io.trajectory import write_tum
    from .native import NativeChannel
    from .runtime.server import Server

    os.makedirs(args.out, exist_ok=True)
    if args.profile == "rendered":
        from .config import rendered_ci_config
        from .utils.camera import Camera

        cfg = rendered_ci_config(factor=args.factor)
        if args.vicinity:
            cfg = cfg.replace(comm=dataclasses.replace(cfg.comm,
                                                       server_kfs_to_client=args.vicinity))
        cam = Camera.from_config(cfg.camera, device)
    else:
        cfg = _build_cfg(args.n_feat)
        cam = _camera(device)
    server = Server(cfg=cfg, cam=cam, vocab=_vocab(args.world_seed, device),
                    n_agents=args.agents, device=device)
    server.quiescence_steps = args.quiescence
    if args.dist_gba:
        from .parallel import dist_ba

        server.mesh = dist_ba.make_mesh(device)
        _event(event="gba_mesh", devices=server.mesh.world_size,
               processes=args.num_processes)

    listen_fd = NativeChannel.listener(args.port)
    _event(event="server_listening", port=args.port)

    inbox: queue.Queue = queue.Queue()
    channels: dict = {}
    lock = threading.Lock()

    def rx_thread(ch):
        """Receives only: messages go to the main thread as they came."""
        agent = None
        try:
            hello = ch.recv()
            agent = int(hello["agent"])
            with lock:
                channels[agent] = ch
            inbox.put((agent, hello))
            while True:
                msg = ch.recv()
                inbox.put((agent, msg))
                if msg.get("type") == "bye":
                    return
        except (ConnectionError, ValueError):
            if agent is not None:
                inbox.put((agent, {"type": "bye"}))

    for _ in range(args.agents):
        ch = NativeChannel.accept(listen_fd)
        threading.Thread(target=rx_thread, args=(ch,), daemon=True).start()

    done = set()
    merges = 0
    t_start = time.time()
    while len(done) < args.agents:
        try:
            agent, msg = inbox.get(timeout=0.05)
        except queue.Empty:
            server.idle_step()
            if time.time() - t_start > args.timeout:
                _event(event="server_timeout")
                break
            continue
        kind = msg.get("type")
        if kind == "hello":
            _event(event="agent_connected", agent=agent)
        elif kind == "map":
            rx = _wire_unpack(msg["msg"], device)
            new_ids = [int(i) for i, v in zip(rx.kfs.kf_id.cpu().numpy(),
                                              rx.kfs.valid.cpu().numpy()) if v]
            ack = server.ingest(agent, rx)
            ag = server.agents[agent]
            for kf_id in new_ids:
                if kf_id in ag.kf_table:
                    _, did_merge = server.mapping_step(agent, ag.kf_table[kf_id])
                    if did_merge:
                        merges += 1
                        _event(event="map_merge", agent=agent, kf=kf_id)
            # vicinity feedback rides the ack
            vic = server.pack_vicinity(agent)
            channels[agent].send({
                "type": "ack", "msg": _wire_pack(ack),
                "vicinity": _wire_pack(vic) if vic.kfs is not None else None,
            })
        elif kind == "reset":
            server.reset_agent(agent)
            _event(event="agent_reset", agent=agent)
        elif kind == "bye":
            done.add(agent)
            _event(event="agent_finished", agent=agent)

    # quiescence -> final GBA (FINALBA), then the trajectories
    for _ in range(server.quiescence_steps + 2):
        server.idle_step()

    summary = {"event": "run_summary", "merges": merges,
               "map_slots": sorted(server.maps.keys()),
               "agents_share_map": len({a.map_slot for a in server.agents.values()}) == 1,
               "trajectories": {}}
    # the kernel launches and the work they follow from: each GBA's
    # (iterations, camera slots, final statistics), the BoW batches of the
    # ingests, the place-recognition searches' BoW transforms and Sim(3)
    # attempts
    searches = [server.matcher.stats] + [f.stats for f in server.finders.values()]
    summary["launches"] = _launches()
    summary["work"] = {"gba": server.stats["gba"], "bow_batches": server.stats["bow_batches"],
                       **{k: sum(s[k] for s in searches)
                          for k in ("bow_transforms", "sim3_attempts")}}
    for a in range(args.agents):
        ts, R, t = server.trajectory(a)
        path = os.path.join(args.out, f"KF_GBA_{a}.csv")
        write_tum(path, ts, R, t)
        summary["trajectories"][a] = {"path": path, "n_kfs": len(ts)}
    if args.save_map:
        for slot in server.maps:
            server.save_map(slot, os.path.join(args.out, f"map_slot{slot}.npz"))
    print(json.dumps(summary), flush=True)


# ----------------------------------------------------------------- client ----


def _connect(args):
    from .native import NativeChannel

    host, port = args.connect.rsplit(":", 1)
    deadline = time.time() + args.timeout
    while True:
        try:
            return NativeChannel.connect(host, int(port))
        except ConnectionError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def run_client(args):
    device = _common_setup(args.cpu)
    from .io.synthetic import agent_corridor, agent_gauge, build_agent_map, make_world
    from .runtime import communicator as comm

    ch = _connect(args)
    ch.send({"type": "hello", "agent": args.agent})
    if args.seq:
        return _run_client_sequence(args, ch, device)
    world, wdesc = make_world(np.random.RandomState(args.world_seed), n=300)
    m_cl = build_agent_map(world, wdesc, agent_corridor(args.agent, n_kfs=args.kfs),
                           agent_gauge(args.agent, device), kf_id_base=0,
                           client_id=args.agent, device=device)

    st = comm.ClientCommState.create(m_cl.kfs.capacity, m_cl.mps.capacity)
    cycles = 0
    while cycles < args.max_cycles:
        msg, st = comm.publish_client(m_cl, st, args.agent,
                                      max_kfs=args.kf_budget, max_mps=args.mp_budget)
        if msg.empty:
            if st.kf_acked[np.where(_own_alive(m_cl, args.agent))[0]].all():
                break
            cycles += 1
            continue
        ch.send({"type": "map", "msg": _wire_pack(msg)})
        reply = _recv_ack(ch)
        st = comm.apply_server_acks(st, m_cl, _wire_unpack(reply["msg"], device))
        cycles += 1
    ch.send({"type": "bye"})
    n_acked = int(st.kf_acked[np.where(_own_alive(m_cl, args.agent))[0]].sum())
    _event(event="client_done", agent=args.agent, kfs_acked=n_acked, cycles=cycles,
           launches=_launches())
    ch.close()


def _seq_cfg(args):
    """The sequence client's configuration.  The server must run the same
    profile (``--profile rendered --factor F``): message shapes follow it."""
    if args.seq.startswith("rendered:"):
        from .config import rendered_ci_config

        return rendered_ci_config(factor=args.factor)
    from .config import DEFAULT_CONFIG

    return DEFAULT_CONFIG


def _seq_frames(args, cfg, device):
    if args.seq.startswith("rendered:"):
        # rendered:<world>:<seed>:<n_frames>[:<span_lo>-<span_hi>], rendered
        # on the client's device
        from .io.rendered import RenderedSequence

        parts = args.seq.split(":")
        world = parts[1] or "corridor"
        seed = int(parts[2]) if len(parts) > 2 else 0
        n_frames = int(parts[3]) if len(parts) > 3 else (args.limit or 120)
        span = (0.0, 1.0)
        if len(parts) > 4:
            lo, _, hi = parts[4].partition("-")
            span = (float(lo), float(hi or 1.0))
        seq = RenderedSequence(world=world, seed=seed, n_frames=n_frames, span=span,
                               cam=cfg.camera, backend="torch", device=device,
                               cache_dir=os.environ.get("CCM_RENDER_CACHE") or None)
    else:
        from .io import euroc

        seq = euroc.EurocSequence(root=args.seq)
    return seq.frames(limit=args.limit)


def _run_client_sequence(args, ch, device):
    """The full tracker interleaved with the publish/ack cycle at
    ``client_pub_freq`` (Tracking + Communicator on one agent process).
    Handles resets (both ends resynchronised) and arena compactions (the
    comm state and the foreign tables remapped)."""
    from .runtime import communicator as comm
    from .runtime.tracker import Tracker
    from .utils.camera import Camera

    cfg = _seq_cfg(args)
    cam = Camera.from_config(cfg.camera, device)
    tracker = Tracker(cfg=cfg, cam=cam, client_id=args.agent, device=device)
    st = comm.ClientCommState.create(cfg.capacity.client_max_kfs, cfg.capacity.client_max_mps)
    foreign_kf, foreign_mp = {}, {}
    epoch = tracker.reset_epoch
    pub_every = max(1, int(cfg.camera.fps / cfg.comm.client_pub_freq))
    n_frames = n_pub = n_resets = 0

    def sync_cycle():
        nonlocal st
        closest = int(tracker.map.kfs.kf_id[tracker.ref_kf])
        msg, st = comm.publish_client(tracker.map, st, args.agent, max_kfs=args.kf_budget,
                                      max_mps=args.mp_budget, current_kf_id=closest)
        if msg.empty:
            return False
        ch.send({"type": "map", "msg": _wire_pack(msg)})
        reply = _recv_ack(ch)
        st = comm.apply_server_acks(st, tracker.map, _wire_unpack(reply["msg"], device))
        vic = _wire_unpack(reply.get("vicinity"), device)
        if vic is not None and vic.kfs is not None and tracker.map is not None:
            tracker.map = comm.ingest_server_map(tracker.map, vic, args.agent, foreign_kf,
                                                 foreign_mp, comm_state=st)
        return True

    for fr in _seq_frames(args, cfg, device):
        tracker.process_image(fr.image, fr.timestamp)
        n_frames += 1
        if tracker.reset_epoch != epoch:
            epoch = tracker.reset_epoch
            n_resets += 1
            st = comm.ClientCommState.create(cfg.capacity.client_max_kfs,
                                             cfg.capacity.client_max_mps)
            foreign_kf.clear()
            foreign_mp.clear()
            ch.send({"type": "reset"})
        if tracker.last_compaction is not None:
            kf_r, mp_r = (np.asarray(r) for r in tracker.last_compaction)
            tracker.last_compaction = None
            st = comm.remap_client_state(st, kf_r, mp_r)
            foreign_kf = {k: int(kf_r[v]) for k, v in foreign_kf.items() if kf_r[v] >= 0}
            foreign_mp = {k: int(mp_r[v]) for k, v in foreign_mp.items() if mp_r[v] >= 0}
        if tracker.map is not None and n_frames % pub_every == 0:
            if sync_cycle():
                n_pub += 1

    # drain: keep publishing until everything alive is acked
    cycles = 0
    while tracker.map is not None and cycles < args.max_cycles:
        if not sync_cycle():
            if st.kf_acked[np.where(_own_alive(tracker.map, args.agent))[0]].all():
                break
        cycles += 1
    ch.send({"type": "bye"})
    m = tracker.map
    n_kfs = 0 if m is None else int(torch.sum(m.kfs.valid & ~m.kfs.bad))
    # the kernel launches and the tracker's counts of the work they follow from
    work = {k: tracker.stats[k]
            for k in ("init_calls", "local_ba_calls", "local_ba_iters", "brute_matches")}
    _event(event="client_done", agent=args.agent, mode="sequence", frames=n_frames,
           kfs=n_kfs, publishes=n_pub, resets=n_resets, launches=_launches(), work=work)
    ch.close()


# ----------------------------------------------------------------- launch ----


def free_port() -> int:
    """A loopback port that was free a moment ago (bind port 0, close)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def module_command(*argv):
    """The command line of a fresh interpreter running this module, and its
    environment (the package importable from any working directory)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)
    return [sys.executable, "-m", "ccm_slam_tpu_torch.deploy", *map(str, argv)], env


def run_launch(args):
    """Single-host smoke deployment: the server and N clients as fresh
    interpreters (never a fork of this process), each on its own device
    (``cuda:0`` for all unless ``--cpu``).  Waits at most ``--timeout``
    seconds for each and kills the processes it started that are still
    running."""
    from . import native

    native._build("native_channel")  # once, before the processes need it
    port = free_port()
    flags = ["--world-seed", args.world_seed, "--n-feat", args.n_feat]
    if args.cpu:
        flags.append("--cpu")
    cmd, env = module_command("server", "--port", port, "--agents", args.agents, "--out",
                              args.out, "--quiescence", args.quiescence, "--timeout",
                              args.timeout, *flags)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)]
    for a in range(args.agents):
        cmd, env = module_command("client", "--agent", a, "--connect", f"127.0.0.1:{port}",
                                  "--kfs", args.kfs, "--timeout", args.timeout, *flags)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env))
    srv, clients = procs[0], procs[1:]
    try:
        rc = [c.wait(timeout=args.timeout) for c in clients]
        out, _ = srv.communicate(timeout=args.timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(out, flush=True)
    for c in clients:
        print(c.stdout.read(), end="", flush=True)
    if any(rc) or srv.returncode:
        raise SystemExit(f"deployment failed: clients={rc} server={srv.returncode}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ccm_slam_tpu_torch.deploy",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="role", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda:0)")
    common.add_argument("--world-seed", type=int, default=2)
    common.add_argument("--n-feat", type=int, default=96)
    common.add_argument("--timeout", type=float, default=600.0)
    common.add_argument("--profile", default="synthetic", choices=["synthetic", "rendered"],
                        help="config profile; both ends of a deployment must "
                             "match (message array shapes follow the config)")
    common.add_argument("--factor", type=float, default=0.4,
                        help="rendered profile resolution factor")
    common.add_argument("--vicinity", type=int, default=0,
                        help="server->client vicinity budget (server role)")

    ps = sub.add_parser("server", parents=[common])
    ps.add_argument("--port", type=int, required=True)
    ps.add_argument("--agents", type=int, default=2)
    ps.add_argument("--out", default="out_mp")
    ps.add_argument("--quiescence", type=int, default=10)
    ps.add_argument("--save-map", action="store_true")
    # a process-spanning GBA group (torch.distributed over TCP): one of these
    # per host; the GBA then shards its landmarks over every rank
    ps.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (enables torch.distributed)")
    ps.add_argument("--num-processes", type=int, default=1)
    ps.add_argument("--process-id", type=int, default=0)
    ps.add_argument("--dist-gba", action="store_true",
                    help="run the server's GBA landmark-sharded over the process "
                         "group (world size 1 without --coordinator)")
    ps.set_defaults(fn=run_server)

    pc = sub.add_parser("client", parents=[common])
    pc.add_argument("--agent", type=int, required=True)
    pc.add_argument("--connect", required=True, help="host:port")
    pc.add_argument("--seq", default=None,
                    help="rendered:<world>:<seed>:<n>[:lo-hi] or an EuRoC root "
                         "(synthetic if unset)")
    pc.add_argument("--limit", type=int, default=None)
    pc.add_argument("--kfs", type=int, default=4)
    pc.add_argument("--kf-budget", type=int, default=2)
    pc.add_argument("--mp-budget", type=int, default=400)
    pc.add_argument("--max-cycles", type=int, default=40)
    pc.set_defaults(fn=run_client)

    pl = sub.add_parser("launch", parents=[common])
    pl.add_argument("--agents", type=int, default=2)
    pl.add_argument("--out", default="out_mp")
    pl.add_argument("--kfs", type=int, default=4)
    pl.add_argument("--quiescence", type=int, default=10)
    pl.set_defaults(fn=run_launch)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
