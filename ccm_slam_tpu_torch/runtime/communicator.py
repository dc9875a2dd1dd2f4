"""Client<->server map synchronization: delta messages, acks, relative
encoding (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/communicator.py`` (the reference's
``Communicator`` and ``ccmslam_msgs`` schema, cslam/src/Communicator.cpp):

* one ``MapMsg`` per cycle: a fixed-capacity batch of keyframes (full or
  pose-update-only), landmarks, ack id arrays and weak acks, as tensors on
  the map's device;
* keyframe poses travel relative to their predecessor (and parent), so the
  server rebuilds them against its own copy in its own gauge
  (KeyFrame.cpp:1334-1366); landmark positions travel in their reference
  keyframe's camera frame (MapPoint.cpp:1012-1055);
* reliability: per-entity sent/acked state on the host (numpy); entities are
  trimmed from the client map only once sent AND acked (CanBeForgotten,
  KeyFrame.cpp:1964-1974); weak acks force a full resend.

``MapMsg.empty`` raises when ``kfs`` is None, as the reference's does
(``communicator.py:97``; the server's ``pack_vicinity`` returns such
messages): a mirrored defect, ROADMAP section 3.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models import map_store as ms
from ..utils.lie import SE3


def _replace(self, **kw):
    return dataclasses.replace(self, **kw)


def _map_fields(batch, fn):
    """A batch of the same type with ``fn`` applied to every field."""
    return type(batch)(**{f.name: fn(getattr(batch, f.name)) for f in dataclasses.fields(batch)})


@dataclass(frozen=True)
class KFMsgBatch:
    valid: torch.Tensor       # [B] bool
    full: torch.Tensor        # [B] full message vs pose-update-only (KFred)
    kf_id: torch.Tensor       # [B] int32
    client_id: torch.Tensor   # [B] int32
    timestamp: torch.Tensor   # [B] f32
    # pose relative to the predecessor: T_c_pred = T_cw o T_predw^-1
    R_cpred: torch.Tensor     # [B,3,3]
    t_cpred: torch.Tensor     # [B,3]
    pred_kf_id: torch.Tensor  # [B] (-1: none -> absolute pose in R_cpred)
    # the spanning-tree parent alternative (KF.msg:32 mTcpar)
    R_cpar: torch.Tensor      # [B,3,3]
    t_cpar: torch.Tensor      # [B,3]
    par_kf_id: torch.Tensor   # [B] (-1: none)
    xy: torch.Tensor          # [B,N,2]
    desc: torch.Tensor        # [B,N,32] uint8
    octave: torch.Tensor      # [B,N] int32
    angle: torch.Tensor       # [B,N] f32
    feat_valid: torch.Tensor  # [B,N] bool
    mp_assoc_id: torch.Tensor  # [B,N] landmark per-agent ids (-1 none)

    replace = _replace


@dataclass(frozen=True)
class MPMsgBatch:
    valid: torch.Tensor       # [B] bool
    full: torch.Tensor        # [B] bool
    mp_id: torch.Tensor       # [B] int32
    client_id: torch.Tensor   # [B] int32
    pos_ref: torch.Tensor     # [B,3] position in the reference KF's camera frame
    ref_kf_id: torch.Tensor   # [B] int32
    ref_client_id: torch.Tensor  # [B] owner of the reference KF
    desc: torch.Tensor        # [B,32] uint8
    normal_ref: torch.Tensor  # [B,3] normal in the reference KF's camera frame
    min_dist: torch.Tensor    # [B]
    max_dist: torch.Tensor    # [B]
    obs_kf_id: torch.Tensor   # [B,O] observing client keyframe ids
    obs_feat: torch.Tensor    # [B,O] feature slot in that keyframe
    obs_valid: torch.Tensor   # [B,O] bool

    replace = _replace


@dataclass
class MapMsg:
    kfs: KFMsgBatch
    mps: MPMsgBatch
    ack_kf_ids: np.ndarray
    ack_mp_ids: np.ndarray
    weak_ack_kf_id: int = -1
    weak_ack_mp_id: int = -1
    closest_kf_id: int = -1
    msg_id: int = 0

    @property
    def empty(self) -> bool:
        # raises on kfs=None as the reference does (a mirrored defect)
        return not bool(torch.any(self.kfs.valid)) and not bool(torch.any(self.mps.valid))


@dataclass
class ClientCommState:
    """Per-entity send state machine, arena-aligned (client side, numpy)."""

    kf_sent: np.ndarray          # version sent so far (-1 = never)
    kf_acked: np.ndarray         # bool
    mp_sent: np.ndarray
    mp_acked: np.ndarray
    kf_sent_msg: np.ndarray      # msg counter of the last send (retry timer)
    mp_sent_msg: np.ndarray
    # entities that arrived FROM the server (vicinity feedback): never re-sent
    # (mbFromServer, Map.cpp:236-240) and forgettable at once
    kf_from_server: np.ndarray = None
    mp_from_server: np.ndarray = None
    msg_counter: int = 0
    resend_after: int = 3        # unacked entities go out again (full) after
                                 # this many publish cycles

    @classmethod
    def create(cls, kf_cap: int, mp_cap: int):
        return cls(
            kf_sent=np.full(kf_cap, -1, np.int64),
            kf_acked=np.zeros(kf_cap, bool),
            mp_sent=np.full(mp_cap, -1, np.int64),
            mp_acked=np.zeros(mp_cap, bool),
            kf_sent_msg=np.full(kf_cap, -1, np.int64),
            mp_sent_msg=np.full(mp_cap, -1, np.int64),
            kf_from_server=np.zeros(kf_cap, bool),
            mp_from_server=np.zeros(mp_cap, bool),
        )


def _h(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _relative_pose(m: ms.MapState, k, pred):
    """T_c_pred = T_cw o T_predw^-1 for arena indices k, pred (pred -1: the
    absolute pose)."""
    T_c = SE3(R=m.kfs.R_cw[k], t=m.kfs.t_cw[k])
    has = pred >= 0
    p = pred.clamp(0, m.kfs.capacity - 1)
    T_rel = T_c.compose(SE3(R=m.kfs.R_cw[p], t=m.kfs.t_cw[p]).inverse())
    return (torch.where(has[:, None, None], T_rel.R, T_c.R),
            torch.where(has[:, None], T_rel.t, T_c.t))


def publish_client(m: ms.MapState, st: ClientCommState, client_id: int, max_kfs: int,
                   max_mps: int, current_kf_id: int = -1):
    """Drain the out-state into one MapMsg (PublishMapClient,
    Communicator.cpp:484-634): full messages for never-sent (or timed-out)
    entities, pose/position updates for moved ones, at most ``max_kfs`` and
    ``max_mps`` per cycle.  Returns (msg, st)."""
    kfs, mps = m.kfs, m.mps
    K, M = kfs.capacity, mps.capacity
    dev = m.device
    kf_valid_h, kf_bad_h, kf_cl_h, ids_np, ver_kf = (
        _h(x) for x in (kfs.valid, kfs.bad, kfs.client_id, kfs.kf_id, kfs.pose_version))
    mp_valid_h, mp_bad_h, mp_cl_h, ver_mp = (
        _h(x) for x in (mps.valid, mps.bad, mps.client_id, mps.pos_version))

    # never re-send entities that came FROM the server (vicinity feedback)
    own_kf = kf_cl_h == client_id
    own_mp = mp_cl_h == client_id
    if st.kf_from_server is not None:
        own_kf = own_kf & ~st.kf_from_server
        own_mp = own_mp & ~st.mp_from_server
    alive_kf = kf_valid_h & ~kf_bad_h & own_kf
    timeout_kf = ((st.kf_sent >= 0) & ~st.kf_acked
                  & (st.msg_counter - st.kf_sent_msg >= st.resend_after))
    need_full_kf = alive_kf & ((st.kf_sent < 0) | timeout_kf)
    need_upd_kf = alive_kf & ~need_full_kf & (st.kf_sent >= 0) & (ver_kf > st.kf_sent)
    # oldest first by kf id (the reference sends in id order)
    order = np.argsort(ids_np, kind="stable")
    sel_kf = [k for k in order if need_full_kf[k] or need_upd_kf[k]][:max_kfs]

    alive_mp = mp_valid_h & ~mp_bad_h & own_mp
    timeout_mp = ((st.mp_sent >= 0) & ~st.mp_acked
                  & (st.msg_counter - st.mp_sent_msg >= st.resend_after))
    need_full_mp = alive_mp & ((st.mp_sent < 0) | timeout_mp)
    need_upd_mp = alive_mp & ~need_full_mp & (st.mp_sent >= 0) & (ver_mp > st.mp_sent)
    sel_mp = np.where(need_full_mp | need_upd_mp)[0][:max_mps]

    kf_idx = np.zeros(max_kfs, np.int64)
    kf_valid = np.zeros(max_kfs, bool)
    kf_full = np.zeros(max_kfs, bool)
    kf_idx[:len(sel_kf)] = sel_kf
    kf_valid[:len(sel_kf)] = True
    kf_full[:len(sel_kf)] = need_full_kf[sel_kf]
    mp_idx = np.zeros(max_mps, np.int64)
    mp_valid = np.zeros(max_mps, bool)
    mp_full = np.zeros(max_mps, bool)
    mp_idx[:len(sel_mp)] = sel_mp
    mp_valid[:len(sel_mp)] = True
    mp_full[:len(sel_mp)] = need_full_mp[sel_mp]
    kf_idx_t = torch.as_tensor(kf_idx, device=dev)
    mp_idx_t = torch.as_tensor(mp_idx, device=dev)

    # predecessor = OWN alive keyframe with the largest id below ours (the
    # server resolves pred_kf_id through this agent's id table)
    ids = kfs.kf_id
    alive_t = kfs.valid & ~kfs.bad & (kfs.client_id == client_id)
    own = ids[kf_idx_t]
    smaller = (ids[None, :] < own[:, None]) & alive_t[None, :]
    has_pred = torch.any(smaller, dim=1)
    pred_arena = torch.argmax(torch.where(smaller, ids[None, :], -1), dim=1)
    pred_arena = torch.where(has_pred, pred_arena, -1)
    R_rel, t_rel = _relative_pose(m, kf_idx_t, pred_arena)
    pred_id = torch.where(has_pred, ids[pred_arena.clamp(0, K - 1)], -1)
    # the parent alternative (mTcpar): the spanning-tree parent when it is an
    # alive own keyframe with a smaller id than ours and not the predecessor
    # (the receiver's chains must stay acyclic; KeyFrame.cpp:715-741)
    parent_derived = ms.spanning_tree(m, ms.covisibility_matrix(m))
    par_arena = torch.where(kfs.parent >= 0, kfs.parent, parent_derived)[kf_idx_t].long()
    pc = par_arena.clamp(0, K - 1)
    par_ok = ((par_arena >= 0) & (kfs.client_id[pc] == client_id) & alive_t[pc]
              & (ids[pc] < own) & (par_arena != pred_arena))
    par_arena = torch.where(par_ok, par_arena, -1)
    R_par, t_par = _relative_pose(m, kf_idx_t, par_arena)
    par_id = torch.where(par_ok, ids[pc], -1)

    assoc = kfs.mp_idx[kf_idx_t]  # [B,N]
    assoc_id = torch.where(assoc >= 0, mps.mp_id[assoc.clamp(0, M - 1).long()], -1)
    i32 = dict(dtype=torch.int32, device=dev)
    kf_batch = KFMsgBatch(
        valid=torch.as_tensor(kf_valid, device=dev),
        full=torch.as_tensor(kf_full, device=dev),
        kf_id=own,
        client_id=torch.full((max_kfs,), client_id, **i32),
        timestamp=kfs.timestamp[kf_idx_t],
        R_cpred=R_rel, t_cpred=t_rel, pred_kf_id=pred_id.to(torch.int32),
        R_cpar=R_par, t_cpar=t_par, par_kf_id=par_id.to(torch.int32),
        xy=kfs.xy[kf_idx_t], desc=kfs.desc[kf_idx_t], octave=kfs.octave[kf_idx_t],
        angle=kfs.angle[kf_idx_t], feat_valid=kfs.feat_valid[kf_idx_t],
        mp_assoc_id=assoc_id.to(torch.int32),
    )

    # landmarks in their reference keyframe's camera frame
    ref = mps.ref_kf[mp_idx_t].clamp(0, K - 1).long()
    T_ref = SE3(R=kfs.R_cw[ref], t=kfs.t_cw[ref])
    O = mps.max_obs
    obs_kf = mps.obs_kf[mp_idx_t]
    obs_ok = (torch.arange(O, device=dev)[None, :] < mps.obs_n[mp_idx_t][:, None]) & (obs_kf >= 0)
    mp_batch = MPMsgBatch(
        valid=torch.as_tensor(mp_valid, device=dev),
        full=torch.as_tensor(mp_full, device=dev),
        mp_id=mps.mp_id[mp_idx_t],
        client_id=torch.full((max_mps,), client_id, **i32),
        pos_ref=T_ref.apply(mps.pos[mp_idx_t]),
        ref_kf_id=kfs.kf_id[ref],
        ref_client_id=torch.full((max_mps,), client_id, **i32),
        desc=mps.desc[mp_idx_t],
        normal_ref=torch.einsum("bij,bj->bi", T_ref.R, mps.normal[mp_idx_t]),
        min_dist=mps.min_dist[mp_idx_t],
        max_dist=mps.max_dist[mp_idx_t],
        obs_kf_id=torch.where(obs_ok, kfs.kf_id[obs_kf.clamp(0, K - 1).long()], -1),
        obs_feat=mps.obs_feat[mp_idx_t],
        obs_valid=obs_ok,
    )

    st.kf_sent = st.kf_sent.copy()
    st.mp_sent = st.mp_sent.copy()
    st.kf_sent_msg = st.kf_sent_msg.copy()
    st.mp_sent_msg = st.mp_sent_msg.copy()
    st.kf_sent[sel_kf] = ver_kf[sel_kf]
    st.kf_sent_msg[sel_kf] = st.msg_counter
    st.mp_sent[sel_mp] = ver_mp[sel_mp]
    st.mp_sent_msg[sel_mp] = st.msg_counter
    st.msg_counter += 1
    return MapMsg(kfs=kf_batch, mps=mp_batch, ack_kf_ids=np.zeros(0, np.int64),
                  ack_mp_ids=np.zeros(0, np.int64), closest_kf_id=current_kf_id,
                  msg_id=st.msg_counter), st


def apply_server_acks(st: ClientCommState, m: ms.MapState, msg: MapMsg) -> ClientCommState:
    """Mark entities acked (MapCbClient, Communicator.cpp:228-260); weak acks
    force a future full resend (SetSendFull).  An ack marks the first arena
    slot holding that id."""
    ids_kf = _h(m.kfs.kf_id)
    ids_mp = _h(m.mps.mp_id)
    st.kf_acked = st.kf_acked.copy()
    st.mp_acked = st.mp_acked.copy()
    for a in msg.ack_kf_ids:
        hits = np.where(ids_kf == a)[0]
        if len(hits):
            st.kf_acked[hits[0]] = True
    for a in msg.ack_mp_ids:
        hits = np.where(ids_mp == a)[0]
        if len(hits):
            st.mp_acked[hits[0]] = True
    if msg.weak_ack_kf_id >= 0:
        st.kf_sent = st.kf_sent.copy()
        st.kf_sent[(ids_kf <= msg.weak_ack_kf_id) & ~st.kf_acked] = -1
    if msg.weak_ack_mp_id >= 0:
        st.mp_sent = st.mp_sent.copy()
        st.mp_sent[(ids_mp <= msg.weak_ack_mp_id) & ~st.mp_acked] = -1
    return st


def trimmable_mask(m: ms.MapState, st: ClientCommState) -> torch.Tensor:
    """CanBeForgotten: sent at least once AND acked (KeyFrame.cpp:1964);
    server-fed vicinity entities are forgettable at once.  [K] bool on the
    map's device."""
    ok = (st.kf_sent >= 0) & st.kf_acked
    if st.kf_from_server is not None:
        ok = ok | st.kf_from_server
    return torch.as_tensor(ok, device=m.device)


def remap_client_state(st: ClientCommState, kf_remap, mp_remap) -> ClientCommState:
    """The arena-aligned send state after a client map compaction
    (``ms.compaction_remap`` gives old -> new): dropped entities' state is
    discarded, fresh slots start never-sent."""
    kf_remap = np.asarray(kf_remap)
    mp_remap = np.asarray(mp_remap)
    new = ClientCommState.create(st.kf_sent.shape[0], st.mp_sent.shape[0])
    new.msg_counter = st.msg_counter
    new.resend_after = st.resend_after
    ksrc = np.where(kf_remap >= 0)[0]
    msrc = np.where(mp_remap >= 0)[0]
    kd, md = kf_remap[ksrc], mp_remap[msrc]
    for name, src, dst in (("kf_sent", ksrc, kd), ("kf_acked", ksrc, kd),
                           ("kf_sent_msg", ksrc, kd), ("mp_sent", msrc, md),
                           ("mp_acked", msrc, md), ("mp_sent_msg", msrc, md)):
        getattr(new, name)[dst] = getattr(st, name)[src]
    if st.kf_from_server is not None:
        new.kf_from_server[kd] = st.kf_from_server[ksrc]
        new.mp_from_server[md] = st.mp_from_server[msrc]
    return new


def ingest_server_map(m: ms.MapState, msg: MapMsg, own_client_id: int,
                      foreign_kf_table: dict, foreign_mp_table: dict,
                      comm_state: ClientCommState = None):
    """Client-side ingestion of server vicinity feedback, batched
    (ProcessKfInClient/ProcessMpInClient, Communicator.cpp:730-1026).

    Foreign keyframes and landmarks enter the client map with their own
    client ids; entities with the agent's OWN id are resolved against the
    live arena: known ones become pose/position updates, trimmed ones are
    re-instantiated and flagged from-server.  Vicinity poses arrive absolute
    in the client gauge.  Foreign tables ({(client_id, id) -> arena}) are
    updated in place and keep rows that trimming later kills, as the
    reference's do (``communicator.py:447``: a mirrored defect).
    ``comm_state`` (optional, updated in place): new arenas are marked
    from-server, own pose updates are recorded as synced.  Returns the map."""
    kfb = msg.kfs
    Bk = int(kfb.valid.shape[0])
    K, M = m.kfs.capacity, m.mps.capacity
    dev = m.device

    own_kf_alive = _h(m.kfs.valid & ~m.kfs.bad) & (_h(m.kfs.client_id) == own_client_id)
    own_kf_ids = _h(m.kfs.kf_id)
    own_kf_lookup = {int(own_kf_ids[k]): int(k) for k in np.where(own_kf_alive)[0]}

    def _kf_arena(c, i):
        if int(c) == own_client_id:
            hit = own_kf_lookup.get(int(i), -1)
            if hit >= 0:
                return hit
        return foreign_kf_table.get((int(c), int(i)), -1)

    def own_mp_lookup():
        alive = _h(m.mps.valid & ~m.mps.bad) & (_h(m.mps.client_id) == own_client_id)
        ids = _h(m.mps.mp_id)
        return {int(ids[p]): int(p) for p in np.where(alive)[0]}

    if Bk:
        valid, cids, ids, full = (_h(x) for x in (kfb.valid, kfb.client_id, kfb.kf_id,
                                                  kfb.full))
        known = np.array([_kf_arena(c, i) for c, i in zip(cids, ids)], np.int32)
        is_upd = valid & (known >= 0)
        room = int(m.next_kf) + np.cumsum((valid & (known < 0) & full).astype(np.int64)) <= K - 1
        is_new = valid & (known < 0) & full & room
        assoc_ids = _h(kfb.mp_assoc_id)
        assoc = np.full(assoc_ids.shape, -1, np.int32)
        if is_new.any():
            lookup = own_mp_lookup()
            for b in np.where(is_new)[0]:
                cid = int(cids[b])
                for j, mid in enumerate(assoc_ids[b]):
                    if mid >= 0:
                        hit = lookup.get(int(mid), -1) if cid == own_client_id else -1
                        if hit < 0:
                            hit = foreign_mp_table.get((cid, int(mid)), -1)
                        assoc[b, j] = hit
        # one scatter for the pose updates
        ui = torch.as_tensor(np.where(is_upd, known, K - 1), device=dev)
        upd = torch.as_tensor(is_upd, device=dev)
        kfs = m.kfs
        kfs = kfs.replace(
            R_cw=ms._add_at(kfs.R_cw, (ui,), torch.where(upd[:, None, None],
                                                         kfb.R_cpred - kfs.R_cw[ui], 0.0), upd),
            t_cw=ms._add_at(kfs.t_cw, (ui,), torch.where(upd[:, None], kfb.t_cpred - kfs.t_cw[ui],
                                                         0.0), upd),
            pose_version=ms._add_at(kfs.pose_version, (ui,), upd.to(torch.int32), upd),
        )
        m = m.replace(kfs=kfs)
        m, arenas = ms.add_keyframes(
            m, kfb.kf_id, kfb.client_id, kfb.timestamp, kfb.R_cpred, kfb.t_cpred, kfb.xy,
            kfb.desc, kfb.octave, kfb.angle, kfb.feat_valid,
            torch.as_tensor(assoc, device=dev), torch.as_tensor(is_new, device=dev))
        arenas = _h(arenas)
        for b in np.where(is_new)[0]:
            foreign_kf_table[(int(cids[b]), int(ids[b]))] = int(arenas[b])
        if comm_state is not None:
            comm_state.kf_from_server[arenas[is_new]] = True
            # own pose updates came FROM the server: record them as synced
            own_upd = is_upd & (cids == own_client_id)
            if own_upd.any():
                vers = _h(m.kfs.pose_version)[known[own_upd]]
                comm_state.kf_sent[known[own_upd]] = np.maximum(
                    comm_state.kf_sent[known[own_upd]], vers)

    mpb = msg.mps
    Bm = int(mpb.valid.shape[0])
    if Bm:
        valid, cids, ids = (_h(x) for x in (mpb.valid, mpb.client_id, mpb.mp_id))
        lookup = own_mp_lookup()

        def _mp_arena(c, i):
            if int(c) == own_client_id:
                hit = lookup.get(int(i), -1)
                if hit >= 0:
                    return hit
            return foreign_mp_table.get((int(c), int(i)), -1)

        known = np.array([_mp_arena(c, i) for c, i in zip(cids, ids)], np.int32)
        ref_arena = np.array([_kf_arena(rc, ri) for rc, ri in zip(_h(mpb.ref_client_id),
                                                                  _h(mpb.ref_kf_id))], np.int32)
        ref_ok = ref_arena >= 0
        is_upd = valid & (known >= 0) & ref_ok
        room = int(m.next_mp) + np.cumsum((valid & (known < 0) & ref_ok).astype(np.int64)) <= M - 2
        is_new = valid & (known < 0) & ref_ok & room
        ra = torch.as_tensor(np.where(ref_ok, ref_arena, 0), device=dev).long()
        T_ref = SE3(R=m.kfs.R_cw[ra], t=m.kfs.t_cw[ra])
        pos_w = T_ref.inverse().apply(mpb.pos_ref)
        normal_w = torch.einsum("bji,bj->bi", T_ref.R, mpb.normal_ref)
        ui = torch.as_tensor(np.where(is_upd, known, M - 1), device=dev)
        upd = torch.as_tensor(is_upd, device=dev)
        mps = m.mps
        mps = mps.replace(
            pos=ms._add_at(mps.pos, (ui,), torch.where(upd[:, None], pos_w - mps.pos[ui], 0.0),
                           upd),
            pos_version=ms._add_at(mps.pos_version, (ui,), upd.to(torch.int32), upd),
        )
        m = m.replace(mps=mps)
        new_t = torch.as_tensor(is_new, device=dev)
        m, arenas = ms.add_mappoints(
            m, n_new=torch.sum(new_t.to(torch.int32)), pos=pos_w, desc=mpb.desc, normal=normal_w,
            min_dist=mpb.min_dist, max_dist=mpb.max_dist, ref_kf=ra.to(torch.int32),
            mp_ids=mpb.mp_id, client_id=mpb.client_id, new_valid=new_t)
        arenas = _h(arenas)
        for b in np.where(is_new)[0]:
            foreign_mp_table[(int(cids[b]), int(ids[b]))] = int(arenas[b])
        if comm_state is not None:
            comm_state.mp_from_server[arenas[is_new]] = True
            own_upd = is_upd & (cids == own_client_id)
            if own_upd.any():
                vers = _h(m.mps.pos_version)[known[own_upd]]
                comm_state.mp_sent[known[own_upd]] = np.maximum(
                    comm_state.mp_sent[known[own_upd]], vers)
    return m
