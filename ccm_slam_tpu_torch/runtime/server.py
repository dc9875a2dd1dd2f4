"""Central server: per-agent map ingestion, place recognition, map fusion and
the global-BA scheduler with the reference's preemption rules (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/server.py`` (the reference's
``ServerSystem`` + ``ClientHandler`` + the server sides of ``Communicator``
and ``LocalMapping``; cslam/src/server/ServerSystem.cpp,
cslam/src/ClientHandler.cpp, Communicator.cpp:167-226 + 382-482,
Mapping.cpp:123-196):

* one ``MapState`` arena per agent until maps merge (then agents share a
  slot), a loop finder per map, one cross-map matcher with a shared bank;
  arenas start at 64 keyframe and 8,192 landmark slots and double near
  their high-water mark (``ensure_capacity``);
* ingestion rebuilds absolute poses through the predecessor chain in the
  map's gauge (``runtime/ingest.py``) with one device-to-host transfer per
  message;
* GBA runs in small interruptible chunks between ingestion steps: fresh
  agent data preempts it (INTERRUPTBA), the merge GBA runs to completion
  (DONOTINTERRUPTMERGE), quiescence triggers the final GBA (FINALBA,
  Communicator.cpp:444-480).  A chunk carries the LM state and reads
  nothing on the host (``gba_cost`` synchronizes on demand).

Mirrored reference defects (ROADMAP section 3): the agent's reported
``closest_kf_id`` carries no client id, so a foreign closest keyframe roots
the vicinity search at the agent's own keyframe of that id
(``server.py:450``); ``pack_vicinity`` returns messages with ``kfs=None``,
whose ``empty`` raises.

With ``mesh`` (``parallel.dist_ba.make_mesh``) every GBA is the
landmark-sharded solve: each rank of the mesh runs the same server on the
same messages, solves its block of landmark rows and gathers the whole map
back.  ``save_map`` / ``load_map`` write and read ``io/checkpoint.py``'s
``.npz``, which the JAX package reads and writes too.

``stats`` counts ingests, the ingests' BoW batches and each GBA's
iterations, camera slots and statistics flag (the matcher and the loop
finders count their own BoW transforms and Sim3 attempts), for callers that
hold the kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..io import checkpoint as ckpt
from ..models import keyframe_db as kdb
from ..models import map_store as ms
from ..ops import bow
from ..parallel import dist_ba
from ..solvers import ba
from ..utils.camera import Camera
from ..utils.lie import SE3, Sim3
from . import ingest as ing
from . import mapping as mapping_mod
from .communicator import KFMsgBatch, MapMsg, MPMsgBatch, _map_fields
from .loop_closing import LoopFinder
from .map_matching import MapMatcher
from .tracking import apply_ba_result, build_ba_problem


@dataclass
class AgentState:
    client_id: int
    map_slot: int
    # client gauge -> server-map gauge (updated on merges; ChangeMap,
    # ClientHandler.cpp:221-241)
    S_map_client: Sim3
    kf_table: dict = field(default_factory=dict)   # client kf_id -> arena idx
    mp_table: dict = field(default_factory=dict)   # client mp_id -> arena idx
    # device id tables (rebuilt lazily from the dicts after merges) and the
    # fixed-capacity pending buffers re-queued into the next ingest
    ing_tables: object = None
    pending_kfb: object = None
    pending_mpb: object = None
    last_data_step: int = -1  # -1: never sent data
    finished: bool = False
    # the agent's reported nearest keyframe (Map.msg ClosestKf_Id): the
    # vicinity search's root
    closest_kf_id: int = -1


@dataclass
class Server:
    cfg: SystemConfig
    cam: Camera
    vocab: bow.Vocabulary
    n_agents: int = 4
    device: Optional[object] = None  # the card unless told otherwise
    maps: Dict[int, ms.MapState] = field(default_factory=dict)
    agents: Dict[int, AgentState] = field(default_factory=dict)
    matcher: MapMatcher = None
    finders: Dict[int, LoopFinder] = field(default_factory=dict)
    step_counter: int = 0
    gba_dirty: Dict[int, bool] = field(default_factory=dict)
    gba_progress: Dict[int, int] = field(default_factory=dict)
    # LM carry (lam, CG warm start, entry cost) across interruptible chunks,
    # dropped whenever the slot's problem changes
    gba_state: Dict[int, object] = field(default_factory=dict)
    final_gba_done: Dict[int, bool] = field(default_factory=dict)
    gba_last_cost: Dict[int, object] = field(default_factory=dict)
    quiescence_steps: int = 30
    gba_chunk_iters: int = 2
    gba_total_iters: int = 20
    mesh: object = None  # parallel.dist_ba.Mesh: landmark-sharded GBA
    stats: dict = field(default_factory=lambda: {"ingests": 0, "bow_batches": 0, "gba": []})

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cap = self.cfg.capacity
        kf0 = min(cap.server_max_kfs, 64)
        mp0 = min(cap.server_max_mps, 8192)
        if self.matcher is None:
            self.matcher = MapMatcher(cfg=self.cfg, cam=self.cam, vocab=self.vocab,
                                      n_slots=self.n_agents, kf_capacity=kf0)
        for a in range(self.n_agents):
            self.maps[a] = ms.empty_map(kf0, mp0, cap.max_keypoints, cap.max_obs_per_mp,
                                        self.device)
            self.agents[a] = AgentState(client_id=a, map_slot=a,
                                        S_map_client=Sim3.identity(device=self.device))
            self.finders[a] = LoopFinder(cfg=self.cfg, cam=self.cam, vocab=self.vocab,
                                         db=kdb.empty_db(kf0, self.vocab.n_words, self.device),
                                         map_id=a)
            self.gba_dirty[a] = False
            self.gba_progress[a] = 0
            self.final_gba_done[a] = False

    # ------------------------------------------------------------------ ingest

    def ensure_capacity(self, slot: int):
        """Geometric arena growth near the high-water mark (append-only:
        arena indices, id tables and bank rows stay valid; the shared bank
        re-grids its per-slot stride)."""
        m = self.maps[slot]
        K, M = m.kfs.capacity, m.mps.capacity
        K1 = K * 2 if int(m.next_kf) >= (K * 17) // 20 else K
        M1 = M * 2 if int(m.next_mp) >= (M * 17) // 20 else M
        if K1 == K and M1 == M:
            return
        self.maps[slot] = ms.grow_map(m, K1, M1)
        if K1 != K:
            self.finders[slot].db = kdb.grow(self.finders[slot].db, K1)
            self.matcher.grow(K1)

    def ingest(self, agent_id: int, msg: MapMsg) -> MapMsg:
        """Process one client message; returns the ack message.  Pending
        buffers go in ahead of the fresh batch; the results come back to the
        host in one transfer."""
        ag = self.agents[agent_id]
        slot = ag.map_slot
        self.ensure_capacity(slot)
        m = self.maps[slot]
        has_data = ing.any_valid(msg.kfs.valid, msg.mps.valid)

        S_g = ag.S_map_client
        cap = self.cfg.capacity
        if ag.ing_tables is None:
            ag.ing_tables = ing.tables_from_dicts(ag.kf_table, ag.mp_table, cap.kf_id_space,
                                                  cap.mp_id_space, self.device)
        Pk = max(8, int(msg.kfs.valid.shape[0]))
        Pm = max(256, int(msg.mps.valid.shape[0]))
        if ag.pending_kfb is None or int(ag.pending_kfb.valid.shape[0]) != Pk:
            ag.pending_kfb = ing.empty_pending(msg.kfs, Pk)
        if ag.pending_mpb is None or int(ag.pending_mpb.valid.shape[0]) != Pm:
            ag.pending_mpb = ing.empty_pending(msg.mps, Pm)

        (m, ag.ing_tables, self.finders[slot].db, self.matcher.db, ag.pending_kfb,
         ag.pending_mpb, out) = ing.server_ingest_full(
            m, ag.ing_tables, self.finders[slot].db, self.matcher.db, ag.pending_kfb,
            ag.pending_mpb, msg.kfs, msg.mps, self.vocab, S_g, agent_id,
            slot * self.matcher.kf_capacity, Pk=Pk, Pm=Pm)
        self.stats["ingests"] += 1
        self.stats["bow_batches"] += 1

        # ---- host bookkeeping: ONE device-to-host transfer per message ----
        host = ing.host_results(dict(out, has_data=has_data))
        if bool(host["has_data"]):
            ag.last_data_step = self.step_counter
            ag.finished = False
            # fresh data preempts a running (non-final) GBA: INTERRUPTBA
            self.gba_progress[slot] = 0
            self.gba_state.pop(slot, None)
            self.final_gba_done[slot] = False
        kf_ids, kf_ack, new_arena = host["kf_ids"], host["kf_ack"], host["new_kf_arena"]
        mp_ids, mp_ack = host["mp_ids"], host["mp_ack"]
        is_new_kf = new_arena >= 0
        for kid, arena in zip(kf_ids[is_new_kf], new_arena[is_new_kf]):
            ag.kf_table[int(kid)] = int(arena)
        for mid, arena in zip(mp_ids[host["mp_new"]], host["mp_arena"][host["mp_new"]]):
            ag.mp_table[int(mid)] = int(arena)
        weak_kf = int(host["max_kf_id"]) if host["weak_kf"] or host["kf_over"] else -1
        weak_mp = int(host["max_mp_id"]) if host["weak_mp"] or host["mp_over"] else -1
        if msg.closest_kf_id >= 0:
            ag.closest_kf_id = int(msg.closest_kf_id)

        self.maps[slot] = m
        self.gba_dirty[slot] = True
        return MapMsg(kfs=_map_fields(msg.kfs, lambda x: x[:0]),
                      mps=_map_fields(msg.mps, lambda x: x[:0]),
                      ack_kf_ids=kf_ids[kf_ack].astype(np.int64),
                      ack_mp_ids=mp_ids[mp_ack].astype(np.int64),
                      weak_ack_kf_id=weak_kf, weak_ack_mp_id=weak_mp)

    def _erase_from_banks(self, slot: int, dead):
        self.finders[slot].db = kdb.erase(self.finders[slot].db, dead)
        gmask = torch.zeros(self.matcher.db.capacity, dtype=torch.bool, device=self.device)
        lo = slot * self.matcher.kf_capacity
        gmask[lo:lo + dead.shape[0]] = dead
        self.matcher.db = kdb.erase(self.matcher.db, gmask)

    def reset_agent(self, agent_id: int):
        """Client reset while connected (Tracking::Reset restarts ids at 0,
        Tracking.cpp:961-985): drop the agent's id tables and pending
        buffers and erase its own entities from its map slot and the banks."""
        ag = self.agents[agent_id]
        slot = ag.map_slot
        m = self.maps[slot]
        own_kf = m.kfs.valid & ~m.kfs.bad & (m.kfs.client_id == agent_id)
        own_mp = m.mps.valid & ~m.mps.bad & (m.mps.client_id == agent_id)
        self.maps[slot] = ms.erase_mappoints(ms.erase_keyframes(m, own_kf), own_mp)
        self._erase_from_banks(slot, own_kf)
        ag.kf_table.clear()
        ag.mp_table.clear()
        ag.ing_tables = ag.pending_kfb = ag.pending_mpb = None
        ag.closest_kf_id = -1
        ag.S_map_client = Sim3.identity(device=self.device)
        ag.last_data_step = -1
        self.gba_state.pop(slot, None)
        self.final_gba_done[slot] = False

    # ------------------------------------------------------------- maintenance

    def mapping_step(self, agent_id: int, new_kf_arena: int, loop_sample=None,
                     merge_sample=None):
        """Server-side per-keyframe maintenance (RunServer, Mapping.cpp:123-196):
        landmark culling, fusion, redundant-keyframe culling, intra-map loop
        closure, then cross-map matching.  ``loop_sample`` / ``merge_sample``:
        the RANSAC sample callables of the loop finder and the matcher (else
        their generators).  Returns (closed, merged)."""
        ag = self.agents[agent_id]
        slot = ag.map_slot
        m = self.maps[slot]
        m, _ = mapping_mod.cull_mappoints_server(m, self.cfg)
        m, _, _, _ = mapping_mod.fuse_neighbors(m, new_kf_arena, self.cam, self.cfg)
        if self.cfg.mapping.red_thres < 1.0:
            m, n_culled = mapping_mod.cull_redundant_keyframes(m, self.cfg)
            if int(n_culled) > 0:
                self._erase_from_banks(slot, m.kfs.valid & m.kfs.bad)
        self.maps[slot] = m
        self.gba_state.pop(slot, None)  # the problem changed: the carry is stale
        m2, closed = self.finders[slot].try_close(m, new_kf_arena, sample=loop_sample)
        self.maps[slot] = m2
        if closed:
            self.gba_dirty[slot] = True
            self.gba_progress[slot] = 0
        res = self.matcher.try_match(slot, self.maps[slot], new_kf_arena,
                                     {s: mm for s, mm in self.maps.items() if s != slot},
                                     sample=merge_sample)
        if res is not None:
            self._apply_merge(slot, res)
        return closed, res is not None

    def _apply_merge(self, slot_from: int, res):
        """Absorb slot_from's map into the matched map and re-route its agents
        (MapMerger::MergeMaps tail + ClientHandler::ChangeMap)."""
        target_slot = res.target_slot
        if target_slot is None or target_slot < 0 or target_slot not in self.maps:
            return
        self.maps[target_slot] = res.fused
        del self.maps[slot_from]
        self.matcher.retire_map(slot_from)
        fused = res.fused
        alive = (fused.kfs.valid & ~fused.kfs.bad).cpu().numpy()
        for k in range(res.kf_offset, int(fused.next_kf)):
            if alive[k]:
                self.matcher.insert_keyframe(target_slot, fused, k)
        # the absorbed map was compacted in the splice: old arena indices go
        # through the exact remap, then the offset
        for ag in self.agents.values():
            if ag.map_slot == slot_from:
                ag.map_slot = target_slot
                ag.S_map_client = res.S_from_to.compose(ag.S_map_client)
                ag.kf_table = {kid: int(res.kf_remap[arena]) + res.kf_offset
                               for kid, arena in ag.kf_table.items() if res.kf_remap[arena] >= 0}
                ag.mp_table = {mid: int(res.mp_remap[arena]) + res.mp_offset
                               for mid, arena in ag.mp_table.items() if res.mp_remap[arena] >= 0}
                ag.ing_tables = None  # point at pre-merge arenas: rebuilt lazily
        # the merge GBA: protected, run to completion now (DONOTINTERRUPTMERGE)
        self._run_gba(target_slot, iters=self.gba_total_iters)
        self.gba_dirty[target_slot] = False
        self.gba_progress[target_slot] = self.gba_total_iters

    # ------------------------------------------------------------------- GBA

    def _run_gba(self, slot: int, iters: int, with_stats: bool = True, carry: bool = False,
                 block: bool = True):
        """One GBA call for a map slot, the two oldest keyframes fixed.
        ``carry=True`` (interruptible chunks) threads the slot's LM state so
        chunks land on the monolithic optimum; the state is dropped on every
        mutation and on arena growth.  ``block=False`` reads nothing on the
        host: the cost stays on the device in ``gba_last_cost`` (read it
        with ``gba_cost``).  With ``mesh`` the solve is landmark-sharded
        (``dist_ba_solve``, no inlier statistics) and every rank gathers the
        whole map back."""
        m = self.maps[slot]
        alive = m.kfs.valid & ~m.kfs.bad
        order = torch.where(alive, m.kfs.insert_order, ms._I32_MAX)
        oldest2 = torch.argsort(order, stable=True)[:2]
        fixed = torch.zeros(m.kfs.capacity, dtype=torch.bool, device=self.device)
        fixed[oldest2] = True
        prob = build_ba_problem(m, self.cam, fixed_mask=fixed)
        state = self.gba_state.get(slot) if carry else None
        if state is not None and state[1].shape[0] != prob.R.shape[0]:
            state = None  # the arena grew between chunks
        if self.mesh is not None:
            R, t, X, cost, new_state = dist_ba.dist_ba_solve(
                dist_ba.shard_problem(prob, self.mesh), self.mesh, iters=iters, state=state,
                return_state=True)
            X = dist_ba.gather_points(X, self.mesh)
        else:
            R, t, X, cost, _, new_state = ba.ba_solve(prob, iters=iters, with_stats=with_stats,
                                                      state=state, return_state=True)
        self.stats["gba"].append((iters, int(prob.R.shape[0]), with_stats and self.mesh is None))
        if carry:
            self.gba_state[slot] = new_state
        else:
            self.gba_state.pop(slot, None)
        self.maps[slot] = apply_ba_result(m, R, t, X, moved_kf_mask=~fixed & alive)
        self.gba_last_cost[slot] = cost
        return float(cost) if block else cost

    def idle_step(self):
        """One scheduler tick: advance interruptible GBAs; the final GBA on
        quiescence (RunServer + FINALBA)."""
        self.step_counter += 1
        for slot in list(self.maps.keys()):
            agents_here = [a for a in self.agents.values() if a.map_slot == slot]
            if not agents_here:
                continue
            if int(self.maps[slot].next_kf) < 3:
                continue  # nothing to optimize yet
            # FINALBA needs agents that SENT data and then went quiet
            # (Communicator.cpp:456-480)
            quiet = all(a.last_data_step >= 0
                        and self.step_counter - a.last_data_step >= self.quiescence_steps
                        for a in agents_here)
            if quiet and not self.final_gba_done[slot]:
                self._run_gba(slot, iters=self.gba_total_iters)
                self.final_gba_done[slot] = True
                self.gba_dirty[slot] = False
                continue
            if self.gba_dirty[slot] and self.gba_progress[slot] < self.gba_total_iters:
                # an interruptible chunk, not waited for
                self._run_gba(slot, iters=self.gba_chunk_iters, with_stats=False, carry=True,
                              block=False)
                self.gba_progress[slot] += self.gba_chunk_iters
                if self.gba_progress[slot] >= self.gba_total_iters:
                    self.gba_dirty[slot] = False

    def gba_cost(self, slot: int):
        """The most recent GBA cost of a slot (synchronizes on it)."""
        c = self.gba_last_cost.get(slot)
        return None if c is None else float(c)

    # --------------------------------------------------------------- vicinity

    def pack_vicinity(self, agent_id: int, max_kfs: int = None, max_mps: int = 2000) -> MapMsg:
        """Server->client feedback: the covisibility neighbourhood of the
        agent's reported nearest keyframe, in the CLIENT's gauge
        (Map::PackVicinityToMsg, cslam/src/Map.cpp:1065-1155).  Off when
        ``comm.server_kfs_to_client`` is 0 (the shipped default)."""
        if max_kfs is None:
            max_kfs = self.cfg.comm.server_kfs_to_client
        ag = self.agents[agent_id]
        m = self.maps[ag.map_slot]
        none = MapMsg(kfs=None, mps=None, ack_kf_ids=np.zeros(0, np.int64),
                      ack_mp_ids=np.zeros(0, np.int64))
        if max_kfs <= 0 or not ag.kf_table:
            return none
        # closest_kf_id carries no client id (a mirrored reference defect)
        start = ag.kf_table.get(ag.closest_kf_id, ag.kf_table[max(ag.kf_table.keys())])
        sel_t, sel_ok = ms.vicinity_khop(m, start, max_kfs)
        sel = sel_t[sel_ok].cpu().numpy().tolist()
        if not sel:
            return none
        dev = self.device
        S_mc = ag.S_map_client
        kfs = m.kfs
        B = len(sel)
        sel_j = torch.as_tensor(sel, dtype=torch.long, device=dev)
        T_cl = SE3(R=kfs.R_cw[sel_j], t=kfs.t_cw[sel_j]).to_sim3().compose(Sim3(
            s=S_mc.s.expand(B), R=S_mc.R.expand(B, 3, 3), t=S_mc.t.expand(B, 3))).to_se3_scaled()
        assoc = kfs.mp_idx[sel_j]
        assoc_id = torch.where(assoc >= 0, m.mps.mp_id[assoc.clamp(0, m.mps.capacity - 1).long()],
                               -1)
        i32 = dict(dtype=torch.int32, device=dev)
        kf_batch = KFMsgBatch(
            valid=torch.ones(B, dtype=torch.bool, device=dev),
            full=torch.ones(B, dtype=torch.bool, device=dev),
            kf_id=kfs.kf_id[sel_j], client_id=kfs.client_id[sel_j],
            timestamp=kfs.timestamp[sel_j], R_cpred=T_cl.R, t_cpred=T_cl.t,
            pred_kf_id=torch.full((B,), -1, **i32),  # absolute, client gauge
            R_cpar=T_cl.R, t_cpar=T_cl.t, par_kf_id=torch.full((B,), -1, **i32),
            xy=kfs.xy[sel_j], desc=kfs.desc[sel_j], octave=kfs.octave[sel_j],
            angle=kfs.angle[sel_j], feat_valid=kfs.feat_valid[sel_j],
            mp_assoc_id=assoc_id.to(torch.int32))

        # the vicinity keyframes' landmarks, in the FIRST vicinity keyframe's
        # camera frame (client gauge)
        mps = m.mps
        lm_mask = np.zeros(mps.capacity, bool)
        for row in assoc.cpu().numpy():
            lm_mask[row[row >= 0]] = True
        lm_mask &= (mps.valid & ~mps.bad).cpu().numpy()
        lm_j = torch.as_tensor(np.where(lm_mask)[0][:max_mps], dtype=torch.long, device=dev)
        Bm = int(lm_j.shape[0])
        T_ref_cl = SE3(R=T_cl.R[0], t=T_cl.t[0])
        nrm_cl = torch.einsum("ij,bj->bi", S_mc.R.T, mps.normal[lm_j])
        mp_batch = MPMsgBatch(
            valid=torch.ones(Bm, dtype=torch.bool, device=dev),
            full=torch.ones(Bm, dtype=torch.bool, device=dev),
            mp_id=mps.mp_id[lm_j], client_id=mps.client_id[lm_j],
            pos_ref=T_ref_cl.apply(S_mc.inverse().apply(mps.pos[lm_j])),
            ref_kf_id=torch.full((Bm,), int(kfs.kf_id[sel[0]]), **i32),
            ref_client_id=torch.full((Bm,), int(kfs.client_id[sel[0]]), **i32),
            desc=mps.desc[lm_j],
            normal_ref=torch.einsum("ij,bj->bi", T_ref_cl.R, nrm_cl),
            min_dist=mps.min_dist[lm_j] / S_mc.s, max_dist=mps.max_dist[lm_j] / S_mc.s,
            obs_kf_id=torch.full((Bm, mps.max_obs), -1, **i32),
            obs_feat=torch.zeros(Bm, mps.max_obs, **i32),
            obs_valid=torch.zeros(Bm, mps.max_obs, dtype=torch.bool, device=dev))
        return MapMsg(kfs=kf_batch, mps=mp_batch, ack_kf_ids=np.zeros(0, np.int64),
                      ack_mp_ids=np.zeros(0, np.int64))

    # ------------------------------------------------------------- load / save

    def save_map(self, slot: int, path: str):
        """Persist one server map (the ``ccmslam_savemap`` service)."""
        ckpt.save_map(path, self.maps[slot])

    def load_map(self, slot: int, path: str):
        """Load a saved map into a slot (the reference's LoadMap flow): ids
        remapped to client 0, alive keyframes registered in the slot's loop
        finder and the matcher (their databases grown to the map's keyframe
        capacity where it is larger), and agent 0's id tables pointed at the
        loaded map, so its re-sent entities become pose updates (the
        reference disables that agent's communication instead,
        Communicator.cpp:51).  The slot's GBA carry is dropped."""
        m = ckpt.remap_to_client(ckpt.load_map(path, self.device), client_id=0)
        self.maps[slot] = m
        finder = self.finders[slot]
        finder.db = kdb.grow(finder.db, m.kfs.capacity)
        self.matcher.grow(m.kfs.capacity)
        ag = self.agents[0]
        ag.map_slot = slot
        alive = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
        ids = m.kfs.kf_id.cpu().numpy()
        for k in np.where(alive)[0]:
            ag.kf_table[int(ids[k])] = int(k)
            finder.insert_keyframe(m, int(k))
            self.matcher.insert_keyframe(slot, m, int(k))
        mp_alive = np.where((m.mps.valid & ~m.mps.bad).cpu().numpy())[0]
        ag.mp_table.update(zip(m.mps.mp_id.cpu().numpy()[mp_alive].tolist(), mp_alive.tolist()))
        ag.ing_tables = None  # rebuilt from the dicts at the next ingest
        self.gba_state.pop(slot, None)
        return m

    # ---------------------------------------------------------------- queries

    def trajectory(self, agent_id: int):
        """(timestamps, R_cw, t_cw) of the agent's alive keyframes in its map
        by kf id (the KF_GBA_<agent>.csv content), as numpy arrays."""
        ag = self.agents[agent_id]
        m = self.maps[ag.map_slot]
        alive = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
        arena = [a for _, a in sorted(ag.kf_table.items()) if alive[a]]
        return (m.kfs.timestamp.cpu().numpy()[arena], m.kfs.R_cw.cpu().numpy()[arena],
                m.kfs.t_cw.cpu().numpy()[arena])
