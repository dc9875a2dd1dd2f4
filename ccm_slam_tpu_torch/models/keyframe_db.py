"""Keyframe database for place recognition (PyTorch).

Counterpart of ``ccm_slam_tpu/models/keyframe_db.py`` (the reference's
``KeyFrameDatabase``, cslam/src/Database.cpp): a dense bank of
L1-normalized BoW vectors aligned with the keyframe arena; a query is one
mat-vec.  ``detect_loop_candidates`` reproduces ``DetectLoopCandidates``
(:72-202): same map only, the query's covisibility list excluded, a floor at
the lowest score among its covisible neighbors, scores accumulated over
covisibility groups, groups within 0.75 of the best kept by their best
member.  ``detect_map_match_candidates`` (:204-327) does the same over the
OTHER maps of the server's shared bank, whose rows are ``slot * stride +
arena index`` (``regrid`` moves them when the stride grows), with
precomputed top-10 neighbour lists in that index space.

Ties: a group is the keyframe and its 10 most covisible keyframes
(``top_k_stable``: integer weights tie often, the lower index comes first,
as in ``jax.lax.top_k``); a group's best member is the first maximum
(``torch.argmax``, as ``jnp.argmax``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import bow
from ..ops.hamming import top_k_stable


@dataclass(frozen=True)
class KeyFrameDB:
    vectors: torch.Tensor  # [K, W] BoW vectors (L1-normalized, tf-idf)
    valid: torch.Tensor    # [K] bool
    map_id: torch.Tensor   # [K] int32: the map the keyframe belongs to

    @property
    def capacity(self):
        return self.vectors.shape[0]

    def replace(self, **kw) -> "KeyFrameDB":
        return dataclasses.replace(self, **kw)


def empty_db(capacity: int, n_words: int, device=None) -> KeyFrameDB:
    """An empty bank on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    return KeyFrameDB(
        vectors=torch.zeros(capacity, n_words, dtype=torch.float32, device=dev),
        valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
        map_id=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
    )


def add(db: KeyFrameDB, kf_idx, vector, map_id) -> KeyFrameDB:
    """Store ``vector`` [W] (or [B,W] at rows ``kf_idx`` [B], distinct)."""
    dev = db.vectors.device
    k = torch.as_tensor(kf_idx, device=dev).long().reshape(-1)
    vec = vector.reshape(k.shape[0], -1)
    return KeyFrameDB(
        vectors=db.vectors.index_put((k,), vec),
        valid=db.valid.index_put((k,), torch.ones_like(k, dtype=torch.bool)),
        map_id=db.map_id.index_put((k,), torch.full_like(k, int(map_id), dtype=torch.int32)),
    )


def batch_vectors(vocab, kfs_desc, kfs_feat_valid, arenas):
    """BoW vectors [B, W] of the keyframes at ``arenas`` (one nearest-word
    call for the batch; computed once, registered in every bank)."""
    safe = arenas.clamp(0, kfs_desc.shape[0] - 1).long()
    vecs, _ = bow.transform_batch(vocab, kfs_desc[safe], kfs_feat_valid[safe])
    return vecs


def register_vectors(db: KeyFrameDB, rows, vecs, mask, map_id) -> KeyFrameDB:
    """Masked batch registration of precomputed vectors at bank ``rows``;
    masked lanes are exact no-ops (the delta-scatter discipline)."""
    safe = rows.clamp(0, db.capacity - 1).long()
    cur = db.vectors[safe]
    dv = torch.where(mask[:, None], vecs - cur, 0.0)
    dm = torch.where(mask, int(map_id) - db.map_id[safe], 0)
    return KeyFrameDB(
        vectors=db.vectors.index_put((safe,), dv, accumulate=True),
        valid=db.valid.to(torch.int32).scatter_reduce(0, safe, mask.to(torch.int32),
                                                      "amax").bool(),
        map_id=db.map_id.index_put((safe,), dm.to(torch.int32), accumulate=True),
    )


def remap(db: KeyFrameDB, kf_remap) -> KeyFrameDB:
    """Move rows through an arena compaction remap (old -> new index, -1 =
    dropped): a compacting system keeps its place-recognition bank.  Kept
    rows land at distinct targets; dropped ones write a spare row."""
    K = db.capacity
    dev = db.vectors.device
    remap_t = torch.as_tensor(kf_remap, device=dev).long()
    ok = (remap_t >= 0) & db.valid
    tgt = torch.where(ok, remap_t.clamp(0, K - 1), K)
    out = empty_db(K + 1, db.vectors.shape[1], dev)
    return KeyFrameDB(
        vectors=out.vectors.index_put((tgt,), db.vectors)[:K],
        valid=out.valid.index_put((tgt,), ok)[:K],
        map_id=out.map_id.index_put((tgt,), db.map_id)[:K],
    )


def erase(db: KeyFrameDB, kf_mask) -> KeyFrameDB:
    return db.replace(valid=db.valid & ~kf_mask)


def grow(db: KeyFrameDB, new_capacity: int) -> KeyFrameDB:
    """Append-only enlargement (rows keep their arena indices)."""
    if new_capacity <= db.capacity:
        return db
    pad = new_capacity - db.capacity
    return KeyFrameDB(
        vectors=torch.nn.functional.pad(db.vectors, (0, 0, 0, pad)),
        valid=torch.nn.functional.pad(db.valid, (0, pad)),
        map_id=torch.nn.functional.pad(db.map_id, (0, pad), value=-1),
    )


def regrid(db: KeyFrameDB, old_stride: int, new_stride: int, n_slots: int) -> KeyFrameDB:
    """Re-place rows packed as ``slot * stride + idx`` onto a larger stride
    (the shared cross-map bank when a map arena grows)."""
    if new_stride == old_stride:
        return db
    dev = db.vectors.device
    out = empty_db(n_slots * new_stride, db.vectors.shape[1], dev)
    old = torch.arange(db.capacity, device=dev)
    new_rows = (old // old_stride) * new_stride + old % old_stride
    return KeyFrameDB(vectors=out.vectors.index_put((new_rows,), db.vectors),
                      valid=out.valid.index_put((new_rows,), db.valid),
                      map_id=out.map_id.index_put((new_rows,), db.map_id))


def _accumulate_covis_groups_nbr(scores, cand, nbr):
    """Group accumulation from precomputed neighbour lists [K, top_k] (the
    sparse form for the shared bank's global index space).  Returns (acc [K],
    best_of_group [K])."""
    K = scores.shape[0]
    group = torch.cat([torch.arange(K, device=nbr.device)[:, None], nbr.long()], dim=1)
    member = torch.where(cand[group], scores[group], 0.0)
    best_local = torch.argmax(member, dim=1)
    return torch.sum(member, dim=1), torch.gather(group, 1, best_local[:, None])[:, 0]


def _accumulate_covis_groups(scores, cand, covis_W, top_k: int = 10):
    """Per keyframe, the accumulated score of its covisibility group (itself
    + its top-10 covisible keyframes that are candidates) and the group's
    best member.  Returns (acc [K], best_of_group [K] index)."""
    K = scores.shape[0]
    _, nbr = top_k_stable(covis_W, top_k)  # [K, top_k]
    group = torch.cat([torch.arange(K, device=nbr.device)[:, None], nbr], dim=1)
    member = torch.where(cand[group], scores[group], 0.0)
    best_local = torch.argmax(member, dim=1)
    return torch.sum(member, dim=1), torch.gather(group, 1, best_local[:, None])[:, 0]


def detect_loop_candidates(db: KeyFrameDB, query_vec, query_kf, query_map_id, covis_W,
                           min_covis_score):
    """Same-map loop candidates for one query keyframe.

    covis_W [K,K]: covisibility weights of the query's map (arena indices
    aligned with the db); min_covis_score: the lowest BoW score between the
    query and its covisible neighbors (the floor).
    Returns (cand_mask [K], scores [K])."""
    scores = bow.score_against_database(query_vec, db.vectors, db.valid)
    K = scores.shape[0]
    dev = scores.device
    q = torch.as_tensor(query_kf, device=dev).long()
    # exclusion = the covisibility LIST (weight >= 15), not any shared
    # landmark (GetConnectedKeyFrames, Database.cpp:85-90)
    connected = covis_W[q] >= 15
    eligible = (db.valid & (db.map_id == int(query_map_id)) & ~connected
                & (torch.arange(K, device=dev) != q))
    cand = eligible & (scores >= torch.clamp(min_covis_score, min=1e-6))
    acc, best_of_group = _accumulate_covis_groups(scores, cand, covis_W)
    acc = torch.where(cand, acc, -1.0)
    best_acc = torch.max(acc)
    keep_group = cand & (acc >= 0.75 * best_acc) & (best_acc > 0)
    # the reference retains the best member of each surviving group
    final = torch.zeros(K, dtype=torch.int32, device=dev).scatter_reduce(
        0, best_of_group, keep_group.to(torch.int32), "amax").bool()
    return final & cand, scores


def detect_map_match_candidates(db: KeyFrameDB, query_vec, query_map_id, covis_nbr_global,
                                min_score: float = 0.0):
    """Cross-map candidates: keyframes of OTHER maps only
    (DetectMapMatchCandidates; merged maps share one map id here).
    covis_nbr_global [n, top_k]: each row's top covisible neighbours in the
    bank's index space.  Returns (cand_mask [n], scores [n])."""
    scores = bow.score_against_database(query_vec, db.vectors, db.valid)
    K = scores.shape[0]
    q_map = int(query_map_id)
    eligible = db.valid & (db.map_id != q_map) & (db.map_id >= 0)
    cand = eligible & (scores > min_score)
    acc, best_of_group = _accumulate_covis_groups_nbr(scores, cand, covis_nbr_global)
    acc = torch.where(cand, acc, -1.0)
    best_acc = torch.max(acc)
    keep_group = cand & (acc >= 0.75 * best_acc) & (best_acc > 0)
    final = torch.zeros(K, dtype=torch.int32, device=scores.device).scatter_reduce(
        0, best_of_group, keep_group.to(torch.int32), "amax").bool()
    return final & cand, scores


def min_covisible_score(db: KeyFrameDB, query_vec, query_kf, covis_W, min_weight: int = 15):
    """(floor score, any neighbor?): the lowest BoW score between the query
    and its covisible neighbors (weight >= 15), LoopFinder::DetectLoop:124-141."""
    scores = bow.l1_score(query_vec[None, :], db.vectors)
    q = torch.as_tensor(query_kf, device=scores.device).long()
    nbr = (covis_W[q] >= min_weight) & db.valid
    return torch.min(torch.where(nbr, scores, float("inf"))), torch.any(nbr)
