"""Batched message ingestion on the server (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/ingest.py`` (the reference's per-entity
``Communicator::ProcessKfInServer``/``ProcessMpInServer``,
cslam/src/Communicator.cpp:815-1139): a whole ``MapMsg`` batch lands in the
server map in one pass.

* **Dense id -> arena tables** (``IngestTables``: [kf_id_space] /
  [mp_id_space] int32 on the device, -1 = unknown) replace the host hash
  maps on the hot path.
* **Keyframes, phase A**: the batch's items in kf-id order (a predecessor
  always has a smaller id, so chains inside a batch resolve in one pass),
  one small step per item on the device: pose-update a known keyframe,
  assign a new arena slot, mark pending (predecessor AND parent missing,
  KeyFrame.cpp:1857-1948) or flag a weak ack (an update for an unknown
  keyframe).  The batch is at most the pending buffer plus
  ``client_pub_max_kfs`` items; nothing is read on the host.
* **Keyframes, phase B**: one ``add_keyframes`` lands every payload.
* **Landmarks**: vectorized -- in-batch duplicate ids (first kept),
  reference-keyframe lookup, Sim3-scaled positions, one ``add_mappoints``,
  forward links and reverse observations by masked scatters.
* Weak acks carry the highest processed id (SetWeakAckKF/MP,
  Communicator.cpp:1286-1300).

A new landmark whose reference keyframe the server has culled is anchored
at its first observer in the batch (or retired without one); the reference
keeps the dead reference, which ``check_structure`` reports (a declared
divergence, ROADMAP section 3).

The id table's landmark scatter keeps the LAST write of an id, as the
reference's scatter does on the CPU: padding rows of a message repeat the id
of the client's arena slot 0 and write the old table entry back after a new
row of that id (the reference then forgets that landmark's table entry
until the tables are rebuilt from the host dicts; mirrored).

``server_ingest_full`` returns its per-item results as device tensors;
``host_results`` moves them to the host in one transfer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..models import keyframe_db as kdb
from ..models import map_store as ms
from ..utils.lie import SE3, Sim3
from .communicator import _map_fields

NO_MP = ms.NO_MP
_BIG = 2**30


@dataclass(frozen=True)
class IngestTables:
    """Per-agent id translation state on the device."""

    kf_id2arena: torch.Tensor  # [kf_id_space] int32 (-1 unknown)
    mp_id2arena: torch.Tensor  # [mp_id_space] int32
    max_kf_id: torch.Tensor    # 0-d int32: highest ingested kf id (weak ack)
    max_mp_id: torch.Tensor    # 0-d int32


def empty_tables(kf_id_space: int = 1 << 16, mp_id_space: int = 1 << 20,
                 device=None) -> IngestTables:
    """Tables that know no id yet (every entry -1, no id ingested)."""
    return tables_from_dicts({}, {}, kf_id_space, mp_id_space, device)


def tables_from_dicts(kf_table: dict, mp_table: dict, kf_id_space: int = 1 << 16,
                      mp_id_space: int = 1 << 20, device=None) -> IngestTables:
    """Device tables rebuilt from the host dicts (after merges remap arenas)."""
    dev = resolve_device(device)
    kf = np.full(kf_id_space, -1, np.int32)
    for i, a in kf_table.items():
        if 0 <= i < kf_id_space:
            kf[i] = a
    mp = np.full(mp_id_space, -1, np.int32)
    for i, a in mp_table.items():
        if 0 <= i < mp_id_space:
            mp[i] = a
    i32 = dict(dtype=torch.int32, device=dev)
    return IngestTables(kf_id2arena=torch.as_tensor(kf, device=dev),
                        mp_id2arena=torch.as_tensor(mp, device=dev),
                        max_kf_id=torch.tensor(max(kf_table.keys(), default=-1), **i32),
                        max_mp_id=torch.tensor(max(mp_table.keys(), default=-1), **i32))


def _lookup(table, idx):
    """table[idx] with -1 for out-of-range or negative ids."""
    ok = (idx >= 0) & (idx < table.shape[0])
    return torch.where(ok, table[idx.clamp(0, table.shape[0] - 1).long()], -1)


def _set_last_wins(table, idx, val):
    """``table.at[idx].set(val)`` where the last lane of a repeated index
    wins (the reference's scatter order on the CPU); one plain write."""
    L = idx.shape[0]
    ti = idx.long()
    order = torch.argsort(ti, stable=True)
    s = ti[order]
    last_sorted = torch.cat([s[1:] != s[:-1], torch.ones(1, dtype=torch.bool, device=s.device)])
    last = torch.zeros(L, dtype=torch.bool, device=s.device).index_put((order,), last_sorted)
    return ms._set_at(table, (ti,), val, last)


def _resolve_keyframes(m: ms.MapState, tkf, kfb, S: Sim3):
    """Phase A: per item in order, resolve the pose (predecessor first,
    parent fallback, absolute when neither is named) and assign an arena
    slot.  Returns (R_all, t_all, pv_all, tkf', weak, per-item outputs)."""
    K = m.kfs.capacity
    dev = m.device
    S_inv = S.inverse()
    R_all, t_all = m.kfs.R_cw.clone(), m.kfs.t_cw.clone()
    pv_all, tkf = m.kfs.pose_version.clone(), tkf.clone()
    next_kf = m.next_kf.clone()
    weak = torch.zeros((), dtype=torch.bool, device=dev)
    # reference-less items: absolute pose in the client gauge -> map gauge
    T_abs = SE3(R=kfb.R_cpred, t=kfb.t_cpred).to_sim3().compose(Sim3(
        s=S_inv.s.expand(kfb.kf_id.shape), R=S_inv.R.expand(kfb.R_cpred.shape),
        t=S_inv.t.expand(kfb.t_cpred.shape))).to_se3_scaled()
    t_cpred, t_cpar = kfb.t_cpred * S.s, kfb.t_cpar * S.s
    ti_all = kfb.kf_id.clamp(0, tkf.shape[0] - 1).long()
    outs = []
    for b in range(kfb.kf_id.shape[0]):
        valid, full = kfb.valid[b], kfb.full[b]
        pred, par = kfb.pred_kf_id[b], kfb.par_kf_id[b]
        known = _lookup(tkf, kfb.kf_id[b])
        pred_arena, par_arena = _lookup(tkf, pred), _lookup(tkf, par)
        use_pred = (pred >= 0) & (pred_arena >= 0)
        use_par = ~use_pred & (par >= 0) & (par_arena >= 0)
        is_abs = (pred < 0) & (par < 0)
        ra = torch.where(use_pred, pred_arena, torch.where(use_par, par_arena, 0))
        ra = ra.clamp(0, K - 1).long()
        T_chain = SE3(R=torch.where(use_par, kfb.R_cpar[b], kfb.R_cpred[b]),
                      t=torch.where(use_par, t_cpar[b], t_cpred[b])).compose(
            SE3(R=R_all[ra], t=t_all[ra]))
        resolved = use_pred | use_par | is_abs
        T_R = torch.where(is_abs, T_abs.R[b], T_chain.R)
        T_t = torch.where(is_abs, T_abs.t[b], T_chain.t)
        is_update = valid & (known >= 0)
        can_add = valid & (known < 0) & full & resolved & (next_kf < K - 1)
        pend = valid & (known < 0) & full & ~resolved
        weak = weak | (valid & (known < 0) & ~full)
        k_new = torch.where(can_add, next_kf, -1)
        ws = torch.where(is_update, known.clamp(0, K - 1),
                         torch.where(can_add, next_kf, K - 1)).long()
        w = is_update | can_add
        R_all[ws] = R_all[ws] + torch.where(w, T_R - R_all[ws], 0.0)
        t_all[ws] = t_all[ws] + torch.where(w, T_t - t_all[ws], 0.0)
        pv_all[ws] = pv_all[ws] + is_update.to(torch.int32)
        next_kf = next_kf + can_add.to(torch.int32)
        ti = ti_all[b]
        tkf[ti] = torch.where(can_add, k_new, tkf[ti]).to(torch.int32)
        outs.append((is_update | can_add, pend, k_new, can_add, T_R, T_t))
    ack, pend, k_new, can_add, T_R, T_t = (torch.stack(x) for x in zip(*outs))
    return R_all, t_all, pv_all, tkf, weak, (ack, pend, k_new.to(torch.int32), can_add, T_R, T_t)


def server_ingest_core(m: ms.MapState, tab: IngestTables, kfb, mpb, S: Sim3, agent_id: int):
    """Ingest one (keyframe batch, landmark batch) into the server map;
    ``S`` maps the client's gauge into the map's.  Returns (m', tab', out)
    with per-item masks: kf_ack, kf_pend, new_kf_arena, mp_ack, mp_pend,
    mp_arena, mp_new, weak_kf, weak_mp."""
    K, M, N = m.kfs.capacity, m.mps.capacity, m.kfs.n_feat
    dev = m.device
    S_s = S.s

    # ---------------- keyframes -------------------------------------------
    Bk = kfb.valid.shape[0]
    order = torch.argsort(torch.where(kfb.valid, kfb.kf_id, _BIG), stable=True)
    kfb = _map_fields(kfb, lambda x: x[order])
    R_all, t_all, pv_all, tkf, weak_kf, (kf_ack, kf_pend, new_arena, can_add, T_R_b, T_t_b) = \
        _resolve_keyframes(m, tab.kf_id2arena, kfb, S)
    m = m.replace(kfs=m.kfs.replace(R_cw=R_all, t_cw=t_all, pose_version=pv_all))

    # phase B: the added keyframes' payloads (slot order = the id order above)
    assoc_arena = _lookup(tab.mp_id2arena, kfb.mp_assoc_id)
    aa = assoc_arena.clamp(0, M - 1).long()
    assoc_ok = (assoc_arena >= 0) & m.mps.valid[aa] & ~m.mps.bad[aa]
    assoc = torch.where(assoc_ok & can_add[:, None], assoc_arena, NO_MP)
    m, _ = ms.add_keyframes(
        m, kfb.kf_id, torch.full((Bk,), agent_id, dtype=torch.int32, device=dev),
        kfb.timestamp, T_R_b, T_t_b, kfb.xy, kfb.desc, kfb.octave, kfb.angle, kfb.feat_valid,
        assoc, can_add)

    # back to the caller's order
    inv = torch.argsort(order, stable=True)
    kf_ack, kf_pend, new_arena = kf_ack[inv], kf_pend[inv], new_arena[inv]
    kf_ids = kfb.kf_id[inv]
    max_kf_id = torch.maximum(tab.max_kf_id, torch.max(torch.where(kf_ack, kf_ids, -1)))

    # ---------------- landmarks: vectorized -------------------------------
    Bm = mpb.valid.shape[0]
    mp_id = mpb.mp_id
    # in-batch duplicates: keep the FIRST occurrence of each id
    sort_i = torch.argsort(torch.where(mpb.valid, mp_id, _BIG), stable=True)
    sorted_ids = mp_id[sort_i]
    dup_sorted = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                            sorted_ids[1:] == sorted_ids[:-1]])
    dup = torch.zeros(Bm, dtype=torch.bool, device=dev).index_put((sort_i,), dup_sorted)
    valid = mpb.valid & ~dup

    ref_arena = _lookup(tkf, mpb.ref_kf_id)
    ref_ok = ref_arena >= 0
    ra = ref_arena.clamp(0, K - 1).long()
    T_ref = SE3(R=m.kfs.R_cw[ra], t=m.kfs.t_cw[ra])
    pos_w = T_ref.inverse().apply(mpb.pos_ref * S_s)
    normal_w = torch.einsum("bji,bj->bi", T_ref.R, mpb.normal_ref)

    known = _lookup(tab.mp_id2arena, mp_id)
    ka = known.clamp(0, M - 1).long()
    known_bad = m.mps.bad[ka]
    is_update = valid & ref_ok & (known >= 0) & ~known_bad
    # retired on the server (fused or culled): ack, never resurrect
    is_retired = valid & (known >= 0) & known_bad
    is_new = valid & ref_ok & (known < 0) & mpb.full
    mp_pend = valid & ~ref_ok & mpb.full
    weak_mp = torch.any(valid & (known < 0) & ~mpb.full)

    # position updates (unique ids after the dedup)
    mps = m.mps
    mps = mps.replace(
        pos=ms._add_at(mps.pos, (ka,), pos_w - mps.pos[ka], is_update),
        pos_version=ms._add_at(mps.pos_version, (ka,), torch.ones_like(known), is_update),
    )
    m = m.replace(mps=mps)

    room = m.next_mp + torch.cumsum(is_new.to(torch.int32), 0) <= M - 2
    is_new = is_new & room
    m, new_mp_arena = ms.add_mappoints(
        m, n_new=torch.sum(is_new.to(torch.int32)), pos=pos_w, desc=mpb.desc, normal=normal_w,
        min_dist=mpb.min_dist * S_s, max_dist=mpb.max_dist * S_s, ref_kf=ra.to(torch.int32),
        mp_ids=mp_id, client_id=torch.full((Bm,), agent_id, dtype=torch.int32, device=dev),
        new_valid=is_new, inserted_stamp=m.next_kf)  # arrival-time age (mInsertedWithKF)
    p_arena = torch.where(is_new, new_mp_arena,
                          torch.where(is_update | is_retired, ka.to(torch.int32), -1))
    tmp = tab.mp_id2arena
    ti = mp_id.clamp(0, tmp.shape[0] - 1).long()
    tmp2 = _set_last_wins(tmp, ti, torch.where(is_new, new_mp_arena, tmp[ti]))

    # observation links [Bm, O]: claim free forward slots on known keyframes,
    # then append the claims to the reverse tables
    obs_kf_arena = _lookup(tkf, mpb.obs_kf_id)
    oka = obs_kf_arena.clamp(0, K - 1).long()
    feat = mpb.obs_feat.clamp(0, N - 1).long()
    link_ok = ((is_new | is_update)[:, None] & mpb.obs_valid & (obs_kf_arena >= 0)
               & ~m.kfs.bad[oka] & (m.kfs.mp_idx[oka, feat] < 0))
    # links past a landmark's last free observation slot are dropped on both
    # sides (a declared divergence: the reference clamps them onto the last
    # slot, where their keyframe and feature indices add up, and keeps their
    # forward links)
    pa = p_arena.clamp(0, M - 1).long()
    rank = torch.cumsum(link_ok.to(torch.int32), 1) - 1
    link_ok = link_ok & (m.mps.obs_n[pa][:, None] + rank < m.mps.max_obs)
    val = p_arena[:, None].expand_as(link_ok)
    mp_idx2 = ms._add_at(m.kfs.mp_idx, (oka, feat), val - m.kfs.mp_idx[oka, feat], link_ok)
    m = m.replace(kfs=m.kfs.replace(mp_idx=mp_idx2))
    mps = m.mps
    slot = (mps.obs_n[pa][:, None] + rank).clamp(0, mps.max_obs - 1).long()
    tgt_p = pa[:, None].expand_as(slot)
    obs_kf = ms._add_at(mps.obs_kf, (tgt_p, slot), oka - mps.obs_kf[tgt_p, slot], link_ok)
    obs_feat = ms._add_at(mps.obs_feat, (tgt_p, slot), feat - mps.obs_feat[tgt_p, slot],
                          link_ok)
    obs_n = ms._add_at(mps.obs_n, (tgt_p,), torch.ones_like(slot), link_ok)
    obs_n = torch.clamp(obs_n, max=mps.max_obs)
    # a new landmark whose reference keyframe the server has culled is
    # anchored at its first (alive) observer, and dies without one (a
    # declared divergence: the reference keeps the dead reference)
    dead_ref = is_new & m.kfs.bad[ra]
    has_obs = obs_n[pa] > 0
    ref_kf = ms._set_at(mps.ref_kf, (pa,), torch.where(has_obs, obs_kf[pa, 0], NO_MP),
                        dead_ref)
    bad = ms._bool_at(mps.bad, pa, dead_ref & ~has_obs, "amax")
    m = m.replace(mps=mps.replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_n=obs_n, ref_kf=ref_kf,
                                  bad=bad))

    mp_ack = is_update | is_new | is_retired
    max_mp_id = torch.maximum(tab.max_mp_id, torch.max(torch.where(mp_ack, mp_id, -1)))
    tab2 = IngestTables(kf_id2arena=tkf, mp_id2arena=tmp2, max_kf_id=max_kf_id.to(torch.int32),
                        max_mp_id=max_mp_id.to(torch.int32))
    out = dict(kf_ack=kf_ack, kf_pend=kf_pend, new_kf_arena=new_arena, mp_ack=mp_ack,
               mp_pend=mp_pend, mp_arena=p_arena, mp_new=is_new, weak_kf=weak_kf,
               weak_mp=weak_mp)
    return m, tab2, out


def empty_pending(batch, capacity: int):
    """An all-invalid pending buffer shaped like ``batch`` ([capacity] rows)."""
    return _map_fields(batch, lambda x: torch.zeros((capacity,) + tuple(x.shape[1:]),
                                                    dtype=x.dtype, device=x.device))


def concat_batches(a, b):
    """Two message batches concatenated along the item axis."""
    return type(a)(**{f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)])
                      for f in dataclasses.fields(a)})


def pack_pending(batch, pend_mask, capacity: int):
    """Left-pack the pending items into a fixed-capacity buffer (valid marks
    the live rows).  Returns (buffer, overflowed 0-d bool)."""
    B = pend_mask.shape[0]
    dev = pend_mask.device
    order = torch.argsort((~pend_mask).to(torch.uint8), stable=True)
    if capacity > B:
        order = torch.cat([order, torch.zeros(capacity - B, dtype=order.dtype, device=dev)])
    order = order[:capacity]
    n = torch.sum(pend_mask.to(torch.int32))
    packed = _map_fields(batch, lambda x: x[order])
    live = torch.arange(capacity, device=dev) < torch.clamp(n, max=capacity)
    return packed.replace(valid=live), n > capacity


def any_valid(a_valid, b_valid):
    """0-d bool: any live row in either mask."""
    return torch.any(a_valid) | torch.any(b_valid)


def server_ingest_full(m: ms.MapState, tab: IngestTables, finder_db, matcher_db, pend_kfb,
                       pend_mpb, kfb, mpb, vocab, S: Sim3, agent_id: int, matcher_base: int,
                       Pk: int, Pm: int):
    """The whole per-message server ingest: pending concat, chain
    resolution, arena landing, BoW vectors (one nearest-word call for the
    batch) and both place-recognition registrations, the pending repack.
    Returns (m', tab', finder_db', matcher_db', pend_kfb', pend_mpb', out);
    out also carries kf_over, mp_over, kf_ids, mp_ids, max_kf_id, max_mp_id
    (device tensors)."""
    kfb = concat_batches(pend_kfb, kfb)
    mpb = concat_batches(pend_mpb, mpb)
    m, tab, out = server_ingest_core(m, tab, kfb, mpb, S, agent_id)

    new_arena = out["new_kf_arena"]
    new_mask = new_arena >= 0
    vecs = kdb.batch_vectors(vocab, m.kfs.desc, m.kfs.feat_valid, new_arena)
    finder_db = kdb.register_vectors(finder_db, new_arena, vecs, new_mask, agent_id)
    rows = torch.where(new_mask, matcher_base + new_arena, -1)
    matcher_db = kdb.register_vectors(matcher_db, rows, vecs, new_mask, agent_id)

    pend_kfb2, kf_over = pack_pending(kfb, out["kf_pend"], Pk)
    pend_mpb2, mp_over = pack_pending(mpb, out["mp_pend"], Pm)
    out = dict(out, kf_over=kf_over, mp_over=mp_over, kf_ids=kfb.kf_id, mp_ids=mpb.mp_id,
               max_kf_id=tab.max_kf_id, max_mp_id=tab.max_mp_id)
    return m, tab, finder_db, matcher_db, pend_kfb2, pend_mpb2, out


def host_results(out: dict) -> dict:
    """The integer and boolean results of ``server_ingest_full`` as numpy
    arrays, moved to the host in ONE transfer."""
    names = list(out)
    flat = [out[k].reshape(-1).to(torch.int64) for k in names]
    host = torch.cat(flat).cpu().numpy()
    res, o = {}, 0
    for k, f in zip(names, flat):
        v = host[o:o + f.shape[0]]
        o += f.shape[0]
        if out[k].dtype == torch.bool:
            v = v.astype(bool)
        res[k] = v.reshape(out[k].shape) if out[k].dim() else v.reshape(())
    return res
