"""Fixed-capacity SoA map arenas: keyframes, landmarks, observations (PyTorch).

Counterpart of ``ccm_slam_tpu/models/map_store.py`` (the client, the loop
closer and the multi-agent server: batched keyframe landing, append-only
growth, the vicinity selection, gauge changes and map merging):

* entities live in struct-of-arrays arenas with validity masks: the arena
  index is the handle, ``(kf_id, client_id)`` keeps the reference's identity;
* every mutation returns a new ``MapState`` (dataclasses of tensors on one
  device); the tensors of the state passed in are never written;
* the observation structure is dual-indexed and fixed-shape: forward
  ``kfs.mp_idx [K,N]`` (feature slot -> landmark) and reverse
  ``mps.obs_kf/obs_feat [M,O]`` (landmark -> observing keyframes);
* covisibility is derived from the observation tables, not maintained.

Scatter discipline (the reference's invariants): a masked scatter is an
add of a delta (``_add_at``: ``index_put(..., accumulate=True)``) where the
reference adds 0 on masked lanes, so collided no-op writes stay no-ops; a
set (``_set_at``) only where the live lanes are distinct; bool flags are
set by monotone max/min scatters (``scatter_reduce`` "amax"/"amin"), never
by ``index_put`` with colliding indices.  The masked lanes write distinct
spare rows that are dropped afterwards: PyTorch's accumulating
``index_put`` on the card serializes colliding lanes.  Forward and reverse
links are kept consistent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import hamming

NO_MP = -1
NO_KF = -1
MAX_LOOP_EDGES = 4
_I32_MAX = 2**31 - 1


def _replace(self, **kw):
    return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class KeyFrameStore:
    kf_id: torch.Tensor        # [K] int32 per-agent id
    client_id: torch.Tensor    # [K] int32
    timestamp: torch.Tensor    # [K] f32 seconds
    valid: torch.Tensor        # [K] bool (slot allocated)
    bad: torch.Tensor          # [K] bool (erased)
    insert_order: torch.Tensor  # [K] int32 arena insertion counter
    R_cw: torch.Tensor         # [K,3,3]
    t_cw: torch.Tensor         # [K,3]
    pose_version: torch.Tensor  # [K] int32
    xy: torch.Tensor           # [K,N,2] undistorted level-0 pixels
    desc: torch.Tensor         # [K,N,32] uint8
    octave: torch.Tensor       # [K,N] int32
    angle: torch.Tensor        # [K,N] f32
    feat_valid: torch.Tensor   # [K,N] bool
    mp_idx: torch.Tensor       # [K,N] int32 landmark arena idx or NO_MP
    parent: torch.Tensor       # [K] int32 spanning-tree parent or NO_KF
    loop_edges: torch.Tensor   # [K,L] int32 loop-closure partners or NO_KF

    replace = _replace

    @property
    def capacity(self):
        return self.kf_id.shape[0]

    @property
    def n_feat(self):
        return self.xy.shape[1]

    def center(self):
        """Camera centres O_w = -R^T t for all slots. [K,3]"""
        return -torch.einsum("kij,ki->kj", self.R_cw, self.t_cw)


@dataclass(frozen=True)
class MapPointStore:
    mp_id: torch.Tensor        # [M] int32 per-agent id
    client_id: torch.Tensor    # [M] int32
    valid: torch.Tensor        # [M] bool
    bad: torch.Tensor          # [M] bool
    pos: torch.Tensor          # [M,3] world
    pos_version: torch.Tensor  # [M] int32
    normal: torch.Tensor       # [M,3] mean viewing direction
    desc: torch.Tensor         # [M,32] uint8 distinctive descriptor
    min_dist: torch.Tensor     # [M] scale-invariance range
    max_dist: torch.Tensor     # [M]
    ref_kf: torch.Tensor       # [M] int32 reference keyframe arena idx
    first_kf_id: torch.Tensor  # [M] int32 (culling age stamp)
    n_visible: torch.Tensor    # [M] int32
    n_found: torch.Tensor      # [M] int32
    obs_kf: torch.Tensor       # [M,O] int32 arena idx or NO_KF
    obs_feat: torch.Tensor     # [M,O] int32 feature slot in that KF
    obs_n: torch.Tensor        # [M] int32 count of valid obs slots

    replace = _replace

    @property
    def capacity(self):
        return self.mp_id.shape[0]

    @property
    def max_obs(self):
        return self.obs_kf.shape[1]


@dataclass(frozen=True)
class MapState:
    kfs: KeyFrameStore
    mps: MapPointStore
    next_kf: torch.Tensor        # 0-d int32 allocation cursor
    next_mp: torch.Tensor
    insert_counter: torch.Tensor  # 0-d int32 monotone KF insertion stamp

    replace = _replace

    @property
    def device(self):
        return self.kfs.R_cw.device


# ---------------------------------------------------------------------------
# Scatter helpers (out of place).
# ---------------------------------------------------------------------------


def _i32(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32)


def _flat_rows(x, index):
    """x viewed as [prod(indexed dims), rest...] and the lanes' row index."""
    d = len(index)
    lin = index[0].long()
    for i, n in zip(index[1:], x.shape[1:d]):
        lin = lin * n + i.long()
    return x.reshape((-1,) + tuple(x.shape[d:])), lin.reshape(-1)


def _spare_rows(x, index, live):
    """x flattened as ``_flat_rows`` gives it, with one spare row per lane
    appended; each lane's target (its row where ``live``, else its own
    spare row, dropped by the caller); and a function that lays a value
    broadcastable to ``x[index]`` out as one row per lane."""
    xf, lin = _flat_rows(x, index)
    L = lin.shape[0]
    lanes = torch.broadcast_shapes(*(i.shape for i in index))
    spare = torch.zeros((L,) + tuple(xf.shape[1:]), dtype=xf.dtype, device=xf.device)
    lane = torch.arange(L, device=lin.device)
    tgt = torch.where(torch.broadcast_to(live, lanes).reshape(-1), lin, xf.shape[0] + lane)

    def per_lane(v):
        return torch.broadcast_to(v, lanes + xf.shape[1:]).reshape((L,) + tuple(xf.shape[1:]))
    return torch.cat([xf, spare]), tgt, per_lane


def _add_at(x, index, delta, live):
    """``x.at[index].add(delta)`` out of place, where only the ``live`` lanes
    write (the reference adds a delta of 0 on the others: the same values).
    Every other lane lands on a spare row of its own, dropped afterwards, so
    only lanes that really collide accumulate together: PyTorch's
    accumulating ``index_put`` on the card serializes colliding lanes.
    uint8 goes through int32 (the wrapped uint8 delta of the reference lands
    on the same value)."""
    xs, tgt, per_lane = _spare_rows(x, index, live)
    if x.dtype == torch.uint8:
        xs = xs.to(torch.int32)
    xs.index_put_((tgt,), per_lane(delta).to(xs.dtype), accumulate=True)
    return xs[:-tgt.shape[0]].reshape(x.shape).to(x.dtype)


def _set_at(x, index, val, live):
    """``x.at[index].set(val)`` on the ``live`` lanes, which must be
    distinct; the others write their own spare rows (a plain ``index_put``
    with no colliding lanes)."""
    xs, tgt, per_lane = _spare_rows(x, index, live)
    xs.index_put_((tgt,), per_lane(val).to(x.dtype))
    return xs[:-tgt.shape[0]].reshape(x.shape)


def _write_rows(field, idx, sel, val):
    """Rows ``idx`` of ``field`` set to ``val`` where ``sel``, as the
    reference writes them: an add of the delta (0 on unselected lanes)."""
    val = torch.as_tensor(val, device=field.device)
    cur = field[idx]
    if field.dtype == torch.uint8:  # uint8 deltas wrap; take them in int32
        val, cur = val.to(torch.int32), cur.to(torch.int32)
    delta = torch.where(_expand(sel, cur), val.to(cur.dtype) - cur, torch.zeros_like(cur))
    return _add_at(field, (idx,), delta, sel)


def _bool_at(x, index, src, reduce):
    """x.at[index].max(src) / .min(src) for bool tensors (1-D index)."""
    out = x.to(torch.int32).scatter_reduce(0, index.long(), src.to(torch.int32), reduce)
    return out.bool()


def _set_row(x, k, val):
    """x.at[k].set(val) for a 0-d index tensor."""
    v = torch.as_tensor(val, device=x.device).to(x.dtype).reshape(1, *x.shape[1:])
    return x.index_put((k.reshape(1).long(),), v)


def _expand(mask, val):
    return mask.reshape(mask.shape + (1,) * (val.dim() - mask.dim()))


def empty_map(capacity_kfs: int, capacity_mps: int, n_feat: int, max_obs: int,
              device=None) -> MapState:
    """An empty arena on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    K, M, N, O = capacity_kfs, capacity_mps, n_feat, max_obs
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    kfs = KeyFrameStore(
        kf_id=torch.full((K,), -1, **i32),
        client_id=torch.zeros(K, **i32),
        timestamp=torch.zeros(K, **f32),
        valid=torch.zeros(K, **b),
        bad=torch.zeros(K, **b),
        insert_order=torch.full((K,), _I32_MAX, **i32),
        R_cw=torch.eye(3, **f32).repeat(K, 1, 1),
        t_cw=torch.zeros(K, 3, **f32),
        pose_version=torch.zeros(K, **i32),
        xy=torch.zeros(K, N, 2, **f32),
        desc=torch.zeros(K, N, 32, dtype=torch.uint8, device=dev),
        octave=torch.zeros(K, N, **i32),
        angle=torch.zeros(K, N, **f32),
        feat_valid=torch.zeros(K, N, **b),
        mp_idx=torch.full((K, N), NO_MP, **i32),
        parent=torch.full((K,), NO_KF, **i32),
        loop_edges=torch.full((K, MAX_LOOP_EDGES), NO_KF, **i32),
    )
    mps = MapPointStore(
        mp_id=torch.full((M,), -1, **i32),
        client_id=torch.zeros(M, **i32),
        valid=torch.zeros(M, **b),
        bad=torch.zeros(M, **b),
        pos=torch.zeros(M, 3, **f32),
        pos_version=torch.zeros(M, **i32),
        normal=torch.zeros(M, 3, **f32),
        desc=torch.zeros(M, 32, dtype=torch.uint8, device=dev),
        min_dist=torch.zeros(M, **f32),
        max_dist=torch.full((M,), float("inf"), **f32),
        ref_kf=torch.full((M,), NO_KF, **i32),
        first_kf_id=torch.full((M,), -1, **i32),
        n_visible=torch.ones(M, **i32),
        n_found=torch.ones(M, **i32),
        obs_kf=torch.full((M, O), NO_KF, **i32),
        obs_feat=torch.zeros(M, O, **i32),
        obs_n=torch.zeros(M, **i32),
    )
    zero = torch.zeros((), **i32)
    return MapState(kfs=kfs, mps=mps, next_kf=zero, next_mp=zero.clone(),
                    insert_counter=zero.clone())


# ---------------------------------------------------------------------------
# Keyframe / landmark allocation
# ---------------------------------------------------------------------------


def grow_map(m: MapState, new_kf_cap: int = None, new_mp_cap: int = None) -> MapState:
    """Enlarge the arenas, keeping content AND arena indices (append-only:
    every table of arena indices stays valid).  New rows get ``empty_map``'s
    defaults."""
    K0, M0 = m.kfs.capacity, m.mps.capacity
    K1 = max(int(new_kf_cap or K0), K0)
    M1 = max(int(new_mp_cap or M0), M0)
    if K1 == K0 and M1 == M0:
        return m
    tmpl = empty_map(K1, M1, m.kfs.n_feat, m.mps.max_obs, m.device)

    def splice(store, new):
        out = {}
        for f in dataclasses.fields(store):
            old, big = getattr(store, f.name), getattr(new, f.name)
            big = big.clone()
            big[:old.shape[0]] = old
            out[f.name] = big
        return type(store)(**out)

    return MapState(kfs=splice(m.kfs, tmpl.kfs), mps=splice(m.mps, tmpl.mps),
                    next_kf=m.next_kf, next_mp=m.next_mp, insert_counter=m.insert_counter)


def add_keyframe(m: MapState, kf_id, client_id, timestamp, R_cw, t_cw, xy, desc, octave,
                 angle, feat_valid, mp_assoc):
    """Allocate the next KF slot.  mp_assoc [N]: landmark arena idx or NO_MP.
    Returns (new_map, kf_arena_idx).  Registers reverse observations."""
    k = m.next_kf
    kfs = m.kfs
    kfs = kfs.replace(
        kf_id=_set_row(kfs.kf_id, k, kf_id),
        client_id=_set_row(kfs.client_id, k, client_id),
        timestamp=_set_row(kfs.timestamp, k, timestamp),
        valid=_set_row(kfs.valid, k, True),
        bad=_set_row(kfs.bad, k, False),
        insert_order=_set_row(kfs.insert_order, k, m.insert_counter),
        R_cw=_set_row(kfs.R_cw, k, R_cw),
        t_cw=_set_row(kfs.t_cw, k, t_cw),
        xy=_set_row(kfs.xy, k, xy),
        desc=_set_row(kfs.desc, k, desc),
        octave=_set_row(kfs.octave, k, octave),
        angle=_set_row(kfs.angle, k, angle),
        feat_valid=_set_row(kfs.feat_valid, k, feat_valid),
        mp_idx=_set_row(kfs.mp_idx, k, mp_assoc),
    )
    m = m.replace(kfs=kfs, next_kf=k + 1, insert_counter=m.insert_counter + 1)
    m = register_observations(m, k, mp_assoc)
    return m, k


def add_keyframes(m: MapState, kf_ids, client_ids, timestamps, R_cw, t_cw, xy, desc, octave,
                  angle, feat_valid, mp_assoc, new_valid):
    """Batch-allocate keyframe slots (the [B]-row analogue of add_keyframe).

    Masked rows write the last slot as exact no-ops (the arena scatter
    discipline).  Reverse observations are registered for all rows at once:
    per-landmark ranks put concurrent observations of one landmark from
    several new keyframes into distinct slots.  Links past a landmark's last
    free observation slot are dropped on both sides (a declared divergence:
    the reference clamps them onto the last slot, where they add up, and
    keeps their forward links).  Returns (map, arena_idx [B], -1 for masked
    rows)."""
    B = kf_ids.shape[0]
    K = m.kfs.capacity
    dev = kf_ids.device
    sel = new_valid
    offs = torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = torch.where(sel, m.next_kf + offs, K - 1).clamp(0, K - 1).long()

    # reverse observations over the flattened [B*N] hits, ranked per landmark
    mps = m.mps
    N = mp_assoc.shape[1]
    flat_mp = torch.where(sel[:, None], mp_assoc, NO_MP).reshape(-1)
    has = flat_mp >= 0
    target = torch.where(has, flat_mp, 0).long()
    skey = torch.where(has, target, 2**30)
    order = torch.argsort(skey, stable=True)
    sorted_t = skey[order]
    first = torch.searchsorted(sorted_t, sorted_t, side="left")
    rank = torch.empty_like(order).index_put((order,), torch.arange(B * N, device=dev) - first)
    fits = has & (mps.obs_n[target] + rank < mps.max_obs)
    mp_assoc = torch.where((has & ~fits).reshape(B, N), NO_MP, mp_assoc)
    kfs = m.kfs

    def upd(field, val):
        return _write_rows(field, idx, sel, val)

    fv_rows = torch.where(_expand(sel, feat_valid), feat_valid, False).to(torch.int32)
    kfs = kfs.replace(
        kf_id=upd(kfs.kf_id, kf_ids),
        client_id=upd(kfs.client_id, client_ids),
        timestamp=upd(kfs.timestamp, timestamps),
        valid=_bool_at(kfs.valid, idx, sel, "amax"),
        bad=_bool_at(kfs.bad, idx, ~sel, "amin"),
        insert_order=upd(kfs.insert_order, m.insert_counter + offs),
        R_cw=upd(kfs.R_cw, R_cw),
        t_cw=upd(kfs.t_cw, t_cw),
        xy=upd(kfs.xy, xy),
        desc=upd(kfs.desc, desc),
        octave=upd(kfs.octave, octave),
        angle=upd(kfs.angle, angle),
        feat_valid=kfs.feat_valid.to(torch.int32).scatter_reduce(
            0, idx[:, None].expand_as(fv_rows), fv_rows, "amax").bool(),
        mp_idx=upd(kfs.mp_idx, mp_assoc),
    )
    n_new = torch.sum(sel.to(torch.int32), dtype=torch.int32)
    m = m.replace(kfs=kfs, next_kf=(m.next_kf + n_new).to(torch.int32),
                  insert_counter=(m.insert_counter + n_new).to(torch.int32))

    slot = (mps.obs_n[target] + rank).clamp(0, mps.max_obs - 1)
    kf_of = idx[:, None].expand(B, N).reshape(-1)
    feat_of = torch.arange(N, device=dev)[None, :].expand(B, N).reshape(-1)
    obs_kf = _add_at(mps.obs_kf, (target, slot), kf_of - mps.obs_kf[target, slot], fits)
    obs_feat = _add_at(mps.obs_feat, (target, slot),
                            feat_of - mps.obs_feat[target, slot], fits)
    obs_n = _add_at(mps.obs_n, (target,), torch.ones_like(target), fits)
    obs_n = torch.clamp(obs_n, max=mps.max_obs)
    m = m.replace(mps=mps.replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_n=obs_n))
    return m, torch.where(sel, idx, -1).to(torch.int32)


def register_observations(m: MapState, kf_idx, mp_assoc) -> MapState:
    """Append (kf_idx, feat) to each associated landmark's reverse-obs table
    (idempotence is not checked, as in the reference)."""
    mps = m.mps
    N = mp_assoc.shape[0]
    dev = mp_assoc.device
    has = mp_assoc >= 0
    target = torch.where(has, mp_assoc, 0).long()
    slot = mps.obs_n[target].clamp(0, mps.max_obs - 1).long()
    old_kf = mps.obs_kf[target, slot]
    old_feat = mps.obs_feat[target, slot]
    kf_idx = _i32(kf_idx, dev)
    obs_kf = _add_at(mps.obs_kf, (target, slot), torch.where(has, kf_idx - old_kf, 0), has)
    feats = torch.arange(N, dtype=torch.int32, device=dev)
    obs_feat = _add_at(mps.obs_feat, (target, slot), torch.where(has, feats - old_feat, 0), has)
    obs_n = _add_at(mps.obs_n, (target,), has.to(torch.int32), has)
    obs_n = torch.clamp(obs_n, max=mps.max_obs)
    return m.replace(mps=mps.replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_n=obs_n))


def add_mappoints(m: MapState, n_new, pos, desc, normal, min_dist, max_dist, ref_kf, mp_ids,
                  client_id, new_valid, inserted_stamp=None):
    """Batch-allocate up to B landmark slots (B = pos.shape[0], actual count
    = n_new via the new_valid mask).  Returns (map, arena_idx [B])."""
    mps = m.mps
    dev = pos.device
    Mcap = mps.capacity
    offs = torch.cumsum(new_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = torch.where(new_valid, m.next_mp + offs, Mcap - 1).clamp(0, Mcap - 1).long()
    sel = new_valid

    def upd(field, val):
        return _write_rows(field, idx, sel, val)

    stamp = ref_kf if inserted_stamp is None else torch.broadcast_to(
        _i32(inserted_stamp, dev), ref_kf.shape)
    mps = mps.replace(
        mp_id=upd(mps.mp_id, mp_ids),
        client_id=upd(mps.client_id, client_id),
        valid=_bool_at(mps.valid, idx, sel, "amax"),
        bad=_bool_at(mps.bad, idx, ~sel, "amin"),
        pos=upd(mps.pos, pos),
        normal=upd(mps.normal, normal),
        desc=upd(mps.desc, desc),
        min_dist=upd(mps.min_dist, min_dist),
        max_dist=upd(mps.max_dist, max_dist),
        ref_kf=upd(mps.ref_kf, ref_kf),
        first_kf_id=upd(mps.first_kf_id, stamp),
        n_visible=upd(mps.n_visible, torch.ones_like(mps.n_visible[idx])),
        n_found=upd(mps.n_found, torch.ones_like(mps.n_found[idx])),
        obs_n=upd(mps.obs_n, torch.zeros_like(mps.obs_n[idx])),
        obs_kf=upd(mps.obs_kf, torch.full_like(mps.obs_kf[idx], NO_KF)),
    )
    m = m.replace(mps=mps, next_mp=(m.next_mp + n_new).to(torch.int32))
    return m, torch.where(new_valid, idx.to(torch.int32), NO_MP)


# ---------------------------------------------------------------------------
# Derived graph structure
# ---------------------------------------------------------------------------


def _slot_valid(mps):
    O = mps.max_obs
    ar = torch.arange(O, device=mps.obs_kf.device)
    return (ar[None, :] < mps.obs_n[:, None]) & (mps.obs_kf >= 0)


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """[K,K] int32: number of landmarks shared between keyframe pairs, from
    the reverse-obs tables (landmark blocks of 8192 keep the incidence
    matrix small)."""
    K = m.kfs.capacity
    mps = m.mps
    dev = mps.obs_kf.device
    sv = _slot_valid(mps) & mps.valid[:, None] & ~mps.bad[:, None]
    tgt = mps.obs_kf.clamp(0, K - 1).long()
    W = torch.zeros(K, K, dtype=torch.float32, device=dev)
    B = 8192
    for b0 in range(0, mps.capacity, B):
        t, s = tgt[b0:b0 + B], sv[b0:b0 + B].to(torch.float32)
        rows = torch.arange(t.shape[0], device=dev)[:, None].expand_as(t)
        A = torch.zeros(t.shape[0], K, dtype=torch.float32, device=dev)
        A = A.index_put((rows, t), s, accumulate=True).clamp(max=1.0)
        W = W + A.T @ A
    W = W.to(torch.int32)
    W = W - torch.diag(torch.diag(W))
    alive = m.kfs.valid & ~m.kfs.bad
    return torch.where(alive[:, None] & alive[None, :], W, 0)


def covis_row(m: MapState, kf_idx) -> torch.Tensor:
    """One keyframe's covisibility row [K] without forming the full matrix."""
    kfs, mps = m.kfs, m.mps
    K = kfs.capacity
    O = mps.max_obs
    dev = kfs.mp_idx.device
    k = torch.as_tensor(kf_idx, device=dev).long()
    mp = kfs.mp_idx[k]
    has = mp >= 0
    mpc = mp.clamp(0, mps.capacity - 1).long()
    sel = has & mps.valid[mpc] & ~mps.bad[mpc]
    obs_kf = mps.obs_kf[mpc]
    ok = (sel[:, None] & (torch.arange(O, device=dev)[None, :] < mps.obs_n[mpc][:, None])
          & (obs_kf >= 0))
    row = torch.zeros(K, dtype=torch.int32, device=dev).index_add(
        0, obs_kf.clamp(0, K - 1).reshape(-1).long(), ok.reshape(-1).to(torch.int32))
    row = row.index_put((k.reshape(1),), torch.zeros(1, dtype=torch.int32, device=dev))
    alive = kfs.valid & ~kfs.bad
    return torch.where(alive, row, 0)


def add_loop_edge(kfs: KeyFrameStore, a, b):
    """Record an undirected loop edge in both endpoints' fixed-size tables
    (KeyFrame::AddLoopEdge; every closure appends).  Duplicates are no-ops.
    Returns (kfs', n_dropped): n_dropped > 0 means an endpoint's table was
    full (callers surface it; no silent caps)."""
    dev = kfs.loop_edges.device

    def app(tbl, i, v):
        i = torch.as_tensor(i, device=dev).long()
        v = _i32(v, dev)
        row = tbl[i]
        dup = torch.any(row == v)
        free = row < 0
        has_free = torch.any(free)
        slot = torch.argmax(free.to(torch.uint8))  # the first free slot
        can = has_free & ~dup
        tbl = _add_at(tbl, (i.reshape(1), slot.reshape(1)),
                      torch.where(can, v - row[slot], 0).reshape(1), can.reshape(1))
        return tbl, (~dup & ~has_free).to(torch.int32)

    tbl, d1 = app(kfs.loop_edges, a, b)
    tbl, d2 = app(tbl, b, a)
    return kfs.replace(loop_edges=tbl), d1 + d2


def vicinity_khop(m: MapState, root, max_kfs: int, hops: int = 4):
    """k-hop covisibility expansion from ``root`` (the selection step of
    Map::PackVicinityToMsg, cslam/src/Map.cpp:1065-1155): per hop, forward
    links -> landmark set, reverse observations -> neighbour set.  Returns
    (sel [max_kfs] arena indices, sel_valid [max_kfs]) ordered by hop,
    then root covisibility (descending), then newest first."""
    kfs, mps = m.kfs, m.mps
    K, M, O = kfs.capacity, mps.capacity, mps.max_obs
    dev = kfs.mp_idx.device
    r = torch.as_tensor(root, device=dev).long()
    alive = kfs.valid & ~kfs.bad
    ar = torch.arange(K, device=dev)
    hop = torch.where(ar == r, 0, K + 1)
    mp = kfs.mp_idx.clamp(0, M - 1).long().reshape(-1)
    mp_has = (kfs.mp_idx >= 0) & kfs.feat_valid & alive[:, None]
    lm_alive = mps.valid & ~mps.bad
    okf = mps.obs_kf.clamp(0, K - 1).long().reshape(-1)
    obs_ok = (torch.arange(O, device=dev)[None, :] < mps.obs_n[:, None]) & (mps.obs_kf >= 0)
    for h in range(hops):
        frontier = hop == h
        lm = _bool_at(torch.zeros(M, dtype=torch.bool, device=dev), mp,
                      (mp_has & frontier[:, None]).reshape(-1), "amax") & lm_alive
        nb = _bool_at(torch.zeros(K, dtype=torch.bool, device=dev), okf,
                      (obs_ok & lm[:, None]).reshape(-1), "amax")
        hop = torch.where(nb & alive & (hop > h + 1), h + 1, hop)
    w_root = covis_row(m, r)
    # lexicographic order by successive stable sorts, least significant first
    o = torch.argsort(-kfs.insert_order, stable=True)
    o = o[torch.argsort(-w_root[o], stable=True)]
    o = o[torch.argsort(hop[o], stable=True)]
    sel = o[:max_kfs]
    return sel.to(torch.int32), hop[sel] <= hops


def covis_neighbors(W, kf_idx, top_k: int, min_weight: int = 15):
    """Top-k covisible neighbors of a keyframe (the weight >= 15 rule,
    KeyFrame.cpp:673), lower index first among equal weights.
    Returns (idx [top_k], weight [top_k], valid [top_k])."""
    row = W[torch.as_tensor(kf_idx, device=W.device).long()]
    w, idx = hamming.top_k_stable(row, top_k)
    return idx, w, w >= min_weight


def spanning_tree(m: MapState, W) -> torch.Tensor:
    """parent[k]: the earlier-inserted alive keyframe with the highest
    covisibility (KeyFrame.cpp:715-741), the first such slot among equal
    weights; roots get NO_KF."""
    order = m.kfs.insert_order
    earlier = order[None, :] < order[:, None]
    alive = m.kfs.valid & ~m.kfs.bad
    Wm = torch.where(earlier & alive[None, :], W, -1)
    best = torch.argmax(Wm, dim=1)
    best_w = torch.gather(Wm, 1, best[:, None])[:, 0]
    return torch.where((best_w > 0) & alive, best.to(torch.int32), NO_KF)


def update_normal_and_depth(m: MapState, scale_factor: float = 1.2,
                            n_levels: int = 8) -> MapState:
    """Landmark viewing normals and scale-invariance distances from the
    observation tables (MapPoint::UpdateNormalAndDepth)."""
    mps, kfs = m.mps, m.kfs
    slot_valid = _slot_valid(mps)
    kf = mps.obs_kf.clamp(0, kfs.capacity - 1).long()
    ctr = kfs.center()
    d = mps.pos[:, None, :] - ctr[kf]
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(slot_valid[..., None], dn, 0.0), dim=1)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)

    refk = mps.ref_kf.clamp(0, kfs.capacity - 1).long()
    dist_ref = torch.linalg.norm(mps.pos - ctr[refk], dim=-1)
    feat = mps.obs_feat.clamp(0, kfs.n_feat - 1).long()
    is_ref = (mps.obs_kf == mps.ref_kf[:, None]) & slot_valid
    ref_slot = torch.argmax(is_ref.to(torch.uint8), dim=1)
    ar = torch.arange(mps.capacity, device=feat.device)
    oct_ref = kfs.octave[refk, feat[ar, ref_slot]]
    level_sf = torch.pow(torch.tensor(scale_factor, dtype=torch.float32, device=feat.device),
                         oct_ref.to(torch.float32))
    max_dist = dist_ref * level_sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    has_obs = mps.obs_n > 0
    return m.replace(mps=mps.replace(
        normal=torch.where(has_obs[:, None], normal, mps.normal),
        max_dist=torch.where(has_obs, max_dist, mps.max_dist),
        min_dist=torch.where(has_obs, min_dist, mps.min_dist),
    ))


def median_last(x):
    """``jnp.median`` along the last axis: (low + high) * 0.5 of the two
    middle values (its "midpoint" method); ``torch.median`` would return the
    lower one for an even count."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def nanmedian(x):
    """``jnp.nanmedian`` of a 1-D tensor (NaN when every entry is NaN):
    averages the two middle values, as ``jnp.nanmedian`` does;
    ``torch.nanmedian`` would return the lower one."""
    s = torch.sort(x).values  # NaN sort last
    cnt = torch.sum(~torch.isnan(x)).to(x.dtype)
    q = 0.5 * (cnt - 1.0)
    lo = torch.clamp(torch.minimum(torch.floor(q), cnt - 1.0), min=0.0).long()
    hi = torch.clamp(torch.minimum(torch.ceil(q), cnt - 1.0), min=0.0).long()
    return (s[lo] + s[hi]) * 0.5


def compute_distinctive_descriptors(m: MapState, chunk: int = 2048) -> MapState:
    """Per-landmark representative descriptor = the observation descriptor
    with the least median Hamming distance to the others
    (MapPoint::ComputeDistinctiveDescriptors).  Distances are exact integers,
    as the reference's bit matmul (``hamming.hamming_self``)."""
    mps, kfs = m.mps, m.kfs
    slot_valid = _slot_valid(mps)
    kf = mps.obs_kf.clamp(0, kfs.capacity - 1).long()
    feat = mps.obs_feat.clamp(0, kfs.n_feat - 1).long()
    descs = kfs.desc[kf, feat]  # [M,O,32]
    big = 1e6
    best = []
    for b0 in range(0, mps.capacity, chunk):
        d = descs[b0:b0 + chunk]
        sv = slot_valid[b0:b0 + chunk]
        dist = hamming.hamming_self(d).to(torch.float32)
        pair_ok = sv[:, :, None] & sv[:, None, :]
        dist = torch.where(pair_ok, dist, big)
        med = torch.where(sv, median_last(dist), big)
        best.append(torch.argmin(med, dim=-1))
    best = torch.cat(best)
    new_desc = descs[torch.arange(mps.capacity, device=best.device), best]
    has = mps.obs_n > 0
    return m.replace(mps=mps.replace(desc=torch.where(has[:, None], new_desc, mps.desc)))


# ---------------------------------------------------------------------------
# Erasure, replacement, compaction
# ---------------------------------------------------------------------------


def erase_mappoints(m: MapState, mp_mask) -> MapState:
    """SetBadFlag for a batch of landmarks: mark bad and detach forward links."""
    mps = m.mps.replace(bad=m.mps.bad | mp_mask)
    kfs = m.kfs
    tgt = kfs.mp_idx.clamp(0, mps.capacity - 1).long()
    dead = mp_mask[tgt] & (kfs.mp_idx >= 0)
    return m.replace(kfs=kfs.replace(mp_idx=torch.where(dead, NO_MP, kfs.mp_idx)), mps=mps)


def erase_keyframes(m: MapState, kf_mask) -> MapState:
    """SetBadFlag for keyframes: mark bad, remove their reverse observations,
    re-anchor landmarks whose reference keyframe died (a landmark left with
    no observation dies with it) and detach forward links to those."""
    kfs = m.kfs.replace(bad=m.kfs.bad | kf_mask)
    mps = m.mps
    K = kfs.capacity
    dev = kf_mask.device
    obs_dead = kf_mask[mps.obs_kf.clamp(0, K - 1).long()] & (mps.obs_kf >= 0)
    obs_kf = torch.where(obs_dead, NO_KF, mps.obs_kf)
    obs_valid = obs_kf >= 0
    within = torch.arange(mps.max_obs, device=dev)[None, :] < mps.obs_n[:, None]
    obs_n = torch.sum((obs_valid & within).to(torch.int32), dim=1, dtype=torch.int32)
    ref_dead = (mps.ref_kf >= 0) & kf_mask[mps.ref_kf.clamp(0, K - 1).long()]
    slot_ok = obs_valid & within
    has_obs = slot_ok.any(dim=1)
    first = torch.argmax(slot_ok.to(torch.uint8), dim=1)
    ar = torch.arange(mps.capacity, device=dev)
    new_ref = torch.where(has_obs, obs_kf[ar, first], NO_KF)
    ref2 = torch.where(ref_dead, new_ref, mps.ref_kf)
    newly_bad = mps.valid & ref_dead & ~has_obs & ~mps.bad
    bad2 = mps.bad | newly_bad
    tgt = kfs.mp_idx.clamp(0, mps.capacity - 1).long()
    dangling = newly_bad[tgt] & (kfs.mp_idx >= 0)
    return m.replace(
        kfs=kfs.replace(mp_idx=torch.where(dangling, NO_MP, kfs.mp_idx)),
        mps=mps.replace(obs_kf=obs_kf, obs_n=obs_n, ref_kf=ref2, bad=bad2),
    )


def rebuild_observations(m: MapState) -> MapState:
    """Rebuild the reverse landmark->keyframe tables from the forward
    ``kfs.mp_idx`` links (sort-based grouping).  Forward links whose
    observation overflows the O-slot cap are dropped from both sides."""
    kfs, mps = m.kfs, m.mps
    K, N = kfs.capacity, kfs.n_feat
    O, M = mps.max_obs, mps.capacity
    dev = kfs.mp_idx.device

    kf_alive = kfs.valid & ~kfs.bad
    mp_flat = kfs.mp_idx.reshape(-1).long()
    live = (mp_flat >= 0) & torch.repeat_interleave(kf_alive, N) & kfs.feat_valid.reshape(-1)
    mp_key = torch.where(live, mp_flat, M)
    order = torch.argsort(mp_key, stable=True)
    sorted_mp = mp_key[order]
    first_of = torch.searchsorted(sorted_mp, torch.arange(M + 1, device=dev))
    rank = torch.arange(K * N, device=dev) - first_of[sorted_mp.clamp(0, M)]
    src_kf = (order // N).to(torch.int32)
    src_feat = (order % N).to(torch.int32)

    # every written (landmark, slot) and every dropped (kf, feat) is distinct;
    # the other lanes write spare rows (no colliding index_put)
    write = (sorted_mp < M) & (rank < O)
    tgt_mp = torch.where(write, sorted_mp, 0)
    tgt_slot = torch.where(write, rank, 0)
    obs_kf = _set_at(torch.full((M, O), NO_KF, dtype=torch.int32, device=dev),
                          (tgt_mp, tgt_slot), src_kf, write)
    obs_feat = _set_at(torch.zeros(M, O, dtype=torch.int32, device=dev),
                            (tgt_mp, tgt_slot), src_feat, write)
    obs_n = torch.clamp(first_of[1:] - first_of[:-1], max=O).to(torch.int32)

    overflow = live[order] & (sorted_mp < M) & (rank >= O)
    mp_idx2 = _set_at(kfs.mp_idx, (src_kf, src_feat),
                           torch.full_like(src_kf, NO_MP), overflow)
    return m.replace(kfs=kfs.replace(mp_idx=mp_idx2),
                     mps=mps.replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_n=obs_n))


def replace_mappoints(m: MapState, loser, winner, rebuild: bool = True) -> MapState:
    """Batched MapPoint::Replace: forward links to ``loser[i]`` move to
    ``winner[i]``, losers are marked bad, the reverse tables are rebuilt
    (unless deferred).  A keyframe row that ends up with the same landmark
    twice keeps its first occurrence.

    A winner that loses in the same batch (a chain x -> y -> z, which the
    loop closer's fusion produces) is followed to the end of its chain, and
    a link whose chain ends on a loser (a cycle) is dropped.  The reference
    redirects one hop only and leaves such links on a landmark marked bad
    (a declared divergence, ROADMAP section 3); without chains both agree."""
    Mcap = m.mps.capacity
    dev = loser.device
    act = (loser >= 0) & (winner >= 0) & (loser != winner)
    safe_l = torch.where(act, loser, Mcap - 1).long()
    won = torch.full((Mcap,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, safe_l, torch.where(act, winner, -1).to(torch.int32), "amax")
    redirect = torch.where(won >= 0, won, torch.arange(Mcap, dtype=torch.int32, device=dev))
    for _ in range(max(1, (Mcap - 1).bit_length())):  # pointer jumping: chains to their end
        redirect = redirect[redirect.long()]
    kfs = m.kfs
    old = kfs.mp_idx
    has = old >= 0
    new = torch.where(has, redirect[old.clamp(0, Mcap - 1).long()], old)
    new = torch.where(has & (won >= 0)[new.clamp(0, Mcap - 1).long()], NO_MP, new)
    K, N = old.shape
    row_sorted_idx = torch.argsort(torch.where(has, new, Mcap + 1), dim=1, stable=True)
    row_sorted = torch.gather(new, 1, row_sorted_idx)
    dup_sorted = torch.cat([torch.zeros(K, 1, dtype=torch.bool, device=dev),
                            row_sorted[:, 1:] == row_sorted[:, :-1]], dim=1) & (row_sorted >= 0)
    dup = torch.zeros(K, N, dtype=torch.bool, device=dev).scatter(1, row_sorted_idx, dup_sorted)
    new = torch.where(dup, NO_MP, new)
    bad = _bool_at(m.mps.bad, torch.where(act, loser, 0), act, "amax")
    m = m.replace(kfs=kfs.replace(mp_idx=new), mps=m.mps.replace(bad=bad))
    return rebuild_observations(m) if rebuild else m


def _lookup(table, idx, none_val):
    safe = idx.clamp(0, table.shape[0] - 1).long()
    return torch.where(idx >= 0, table[safe], none_val)


def _keep_masks(m: MapState):
    kf_keep = m.kfs.valid & ~m.kfs.bad
    mp_keep = m.mps.valid & ~m.mps.bad & (m.mps.obs_n > 0)
    return kf_keep, mp_keep


def compact_observations(m: MapState) -> MapState:
    """Left-pack each landmark's reverse-obs slots (after erasures)."""
    mps = m.mps
    alive = mps.obs_kf >= 0
    order = torch.argsort((~alive).to(torch.uint8), dim=1, stable=True)
    return m.replace(mps=mps.replace(
        obs_kf=torch.gather(mps.obs_kf, 1, order),
        obs_feat=torch.gather(mps.obs_feat, 1, order),
        obs_n=torch.sum(alive.to(torch.int32), dim=1, dtype=torch.int32),
    ))


def compact_map(m: MapState) -> MapState:
    """Defragment both arenas: drop bad/erased entities, left-pack the alive
    ones in their order, remap every cross-index (mp_idx, obs_kf, ref_kf,
    parent, loop_edges).  Shapes are preserved."""
    kfs, mps = m.kfs, m.mps
    K, M = kfs.capacity, mps.capacity
    dev = kfs.mp_idx.device
    kf_keep, mp_keep = _keep_masks(m)
    kf_perm = torch.argsort((~kf_keep).to(torch.uint8), stable=True)
    mp_perm = torch.argsort((~mp_keep).to(torch.uint8), stable=True)
    n_kf = torch.sum(kf_keep.to(torch.int32), dtype=torch.int32)
    n_mp = torch.sum(mp_keep.to(torch.int32), dtype=torch.int32)
    kf_remap = torch.full((K,), NO_KF, dtype=torch.int32, device=dev).index_put(
        (kf_perm,), torch.arange(K, dtype=torch.int32, device=dev))
    kf_remap = torch.where(kf_keep, kf_remap, NO_KF)
    mp_remap = torch.full((M,), NO_MP, dtype=torch.int32, device=dev).index_put(
        (mp_perm,), torch.arange(M, dtype=torch.int32, device=dev))
    mp_remap = torch.where(mp_keep, mp_remap, NO_MP)

    kfs2 = KeyFrameStore(**{f.name: getattr(kfs, f.name)[kf_perm]
                            for f in dataclasses.fields(kfs)})
    kfs2 = kfs2.replace(
        valid=torch.arange(K, device=dev) < n_kf,
        bad=torch.zeros(K, dtype=torch.bool, device=dev),
        mp_idx=_lookup(mp_remap, kfs2.mp_idx, NO_MP),
        parent=_lookup(kf_remap, kfs2.parent, NO_KF),
        loop_edges=_lookup(kf_remap, kfs2.loop_edges, NO_KF),
    )
    mps2 = MapPointStore(**{f.name: getattr(mps, f.name)[mp_perm]
                            for f in dataclasses.fields(mps)})
    mps2 = mps2.replace(
        valid=torch.arange(M, device=dev) < n_mp,
        bad=torch.zeros(M, dtype=torch.bool, device=dev),
        obs_kf=_lookup(kf_remap, mps2.obs_kf, NO_KF),
        ref_kf=_lookup(kf_remap, mps2.ref_kf, NO_KF),
    )
    m2 = compact_observations(m.replace(kfs=kfs2, mps=mps2, next_kf=n_kf, next_mp=n_mp))
    mps3 = m2.mps
    no_ref = (mps3.ref_kf < 0) & mps3.valid
    return m2.replace(mps=mps3.replace(ref_kf=torch.where(no_ref, mps3.obs_kf[:, 0],
                                                          mps3.ref_kf)))


def transform_map(m: MapState, s, R, t) -> MapState:
    """Apply a Sim3 gauge change S = (s, R, t): world' = S(world).  Poses
    become se3(T_cw o S^-1): rotation R_cw R^T, translation
    s (t_cw - R_cw R^T t / s); positions s R X + t (MapMerger.cpp:349-395)."""
    kfs, mps = m.kfs, m.mps
    dev = kfs.R_cw.device
    s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    Rt = R.T
    new_R = kfs.R_cw @ Rt
    trans_sim = (kfs.R_cw @ (-(Rt @ t) / s)) + kfs.t_cw
    return m.replace(
        kfs=kfs.replace(R_cw=new_R, t_cw=trans_sim * s, pose_version=kfs.pose_version + 1),
        mps=mps.replace(pos=s * (mps.pos @ R.T) + t, pos_version=mps.pos_version + 1),
    )


def merge_maps(m_into: MapState, m_from: MapState, s, R, t) -> MapState:
    """Union map (the Map merge constructor, cslam/src/Map.cpp:70-172):
    ``m_from`` compacted, moved by the Sim3 (s, R, t) into ``m_into``'s
    world and appended at ``m_into``'s cursors; ``m_from``'s arena index i
    becomes ``m_into.next_kf + i`` (landmarks likewise).  The result keeps
    ``m_into``'s capacity.  ``m_from``'s whole arena is written from the
    cursor on, clipped at the last slot as the reference's scatter does:
    when it runs past the end, the last slot keeps ``m_into``'s row (the
    reference's last write wins)."""
    a = m_into
    b = transform_map(compact_map(m_from), s, R, t)
    nk, nm = a.next_kf, a.next_mp
    dev = a.device

    def off(x, n):
        return torch.where(x >= 0, x + n, x)

    bk = b.kfs.replace(
        mp_idx=off(b.kfs.mp_idx, nm), parent=off(b.kfs.parent, nk),
        loop_edges=off(b.kfs.loop_edges, nk),
        insert_order=torch.where(b.kfs.valid, b.kfs.insert_order + a.insert_counter,
                                 b.kfs.insert_order),
    )
    bm = b.mps.replace(obs_kf=off(b.mps.obs_kf, nk), ref_kf=off(b.mps.ref_kf, nk))

    def splice(dst_store, src_store, cursor, n_src, cap):
        idx = cursor + torch.arange(n_src, device=dev)
        write = (idx < cap - 1) | ((idx == cap - 1) & (cursor + n_src <= cap))
        tgt = idx.clamp(0, cap - 1)
        return type(dst_store)(**{
            f.name: _set_at(getattr(dst_store, f.name), (tgt,), getattr(src_store, f.name),
                                 write)
            for f in dataclasses.fields(dst_store)})

    return a.replace(
        kfs=splice(a.kfs, bk, nk, b.kfs.capacity, a.kfs.capacity),
        mps=splice(a.mps, bm, nm, b.mps.capacity, a.mps.capacity),
        next_kf=(nk + b.next_kf).to(torch.int32),
        next_mp=(nm + b.next_mp).to(torch.int32),
        insert_counter=(a.insert_counter + b.insert_counter).to(torch.int32),
    )


def compaction_remap(m: MapState):
    """The old->new arena index mapping that compact_map would apply (numpy
    int64 arrays; -1 = dropped), for callers holding external index tables."""
    kf_keep, mp_keep = (np.asarray(x.cpu()) for x in _keep_masks(m))
    kf_map = np.full(kf_keep.shape[0], -1, np.int64)
    kf_map[kf_keep] = np.arange(kf_keep.sum())
    mp_map = np.full(mp_keep.shape[0], -1, np.int64)
    mp_map[mp_keep] = np.arange(mp_keep.sum())
    return kf_map, mp_map


def check_structure(m: MapState) -> list:
    """Deep structural validation (the reference's Map::CheckStructure) on
    the host.  Returns a list of violations (empty = OK): forward links and
    reverse tables agree, obs_n matches the populated slots, alive landmarks
    reference an alive keyframe, keyframe ids are unique per client, the
    fill counters bound the valid flags."""
    errs = []
    kfs, mps = m.kfs, m.mps
    K, M, N, O = kfs.capacity, mps.capacity, kfs.n_feat, mps.max_obs

    def h(x):
        return np.asarray(x.detach().cpu())

    kf_alive = h(kfs.valid & ~kfs.bad)
    mp_alive = h(mps.valid & ~mps.bad)
    mp_idx, obs_kf, obs_feat, obs_n = h(kfs.mp_idx), h(mps.obs_kf), h(mps.obs_feat), h(mps.obs_n)
    feat_valid = h(kfs.feat_valid)

    if kf_alive[int(m.next_kf):].any():
        errs.append("valid keyframe beyond next_kf fill counter")
    if mp_alive[int(m.next_mp):].any():
        errs.append("valid landmark beyond next_mp fill counter")
    pairs = list(zip(h(kfs.client_id)[kf_alive].tolist(), h(kfs.kf_id)[kf_alive].tolist()))
    if len(pairs) != len(set(pairs)):
        errs.append("duplicate (client_id, kf_id) among alive keyframes")

    for p in np.where(mp_alive)[0]:
        n = int(obs_n[p])
        if n > O:
            errs.append(f"mp {p}: obs_n {n} > capacity {O}")
            continue
        for s in range(n):
            k, f = int(obs_kf[p, s]), int(obs_feat[p, s])
            if k < 0 or k >= K or not kf_alive[k]:
                errs.append(f"mp {p} obs slot {s}: dead/invalid keyframe {k}")
            elif f < 0 or f >= N or not feat_valid[k, f]:
                errs.append(f"mp {p} obs slot {s}: invalid feature {f} of kf {k}")
            elif mp_idx[k, f] != p:
                errs.append(f"mp {p} obs slot {s}: kf {k} feat {f} forward link is "
                            f"{int(mp_idx[k, f])} (reverse/forward mismatch)")
        if (obs_kf[p, n:O] != NO_KF).any():
            errs.append(f"mp {p}: populated obs slot beyond obs_n={n}")

    for k in np.where(kf_alive)[0]:
        row = mp_idx[k]
        for f in np.where(row >= 0)[0]:
            p = int(row[f])
            if p >= M or not mp_alive[p]:
                errs.append(f"kf {k} feat {f}: forward link to dead landmark {p}")
                continue
            n = int(obs_n[p])
            if not ((obs_kf[p, :n] == k) & (obs_feat[p, :n] == f)).any():
                errs.append(f"kf {k} feat {f} -> mp {p}: forward link missing from "
                            "the reverse table")

    ref = h(mps.ref_kf)
    for p in np.where(mp_alive)[0]:
        r = int(ref[p])
        if r < 0 or r >= K or not kf_alive[r]:
            errs.append(f"mp {p}: reference keyframe {r} dead/invalid")
    return errs
