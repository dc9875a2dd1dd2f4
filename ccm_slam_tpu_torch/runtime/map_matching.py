"""Inter-map place recognition and map fusion (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/map_matching.py`` (the reference's
``MapMatcher``, cslam/src/MapMatcher.cpp, and ``MapMerger``,
cslam/src/MapMerger.cpp).  Maps are immutable states, so fusion is
speculative: a trial union map is spliced, the Sim3 and the guided
projection are evaluated on it, and only on success does the
gauge-corrected fused map replace the originals.

  MapMatcher::DetectLoop  -> MapMatcher.detect() over the shared bank
  MapMatcher::ComputeSim3 -> estimate_sim3() on the trial union arena
  MapMerger::MergeMaps    -> merge_maps (gauge Sim3) + correct_loop

Randomness: each attempt's RANSAC samples come from ``sample`` (a callable
taking the match mask, as ``LoopFinder.try_close`` takes one) or from
``rng``, a ``torch.Generator`` seeded 777 (the reference splits
``PRNGKey(777)`` once per attempt).  Ties: the shared bank's covisibility
neighbour lists take ``top_k_stable`` (``jax.lax.top_k``'s order).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..models import keyframe_db as kdb
from ..models import map_store as ms
from ..ops import bow
from ..ops.hamming import top_k_stable
from ..utils.lie import SE3, Sim3
from .loop_closing import correct_loop, estimate_sim3, guided_projection_count


def gauge_from_match(m_fused: ms.MapState, kf_q_off, kf_c, S_qc: Sim3) -> Sim3:
    """The Sim3 mapping the query map's world into the matched map's:
    (S_qc o T_cw(candidate))^-1 o T_qw(query) (``g2oS_wm_wc``,
    MapMerger.cpp:279-284)."""
    kfs = m_fused.kfs
    T_c = SE3(R=kfs.R_cw[kf_c], t=kfs.t_cw[kf_c])
    T_q = SE3(R=kfs.R_cw[kf_q_off], t=kfs.t_cw[kf_q_off])
    return S_qc.compose(T_c.to_sim3()).inverse().compose(T_q.to_sim3())


@dataclass
class MergeResult:
    fused: ms.MapState
    S_from_to: Sim3      # maps the absorbed map's world into the fused world
    kf_offset: int       # the absorbed map's keyframe arena offset in the fused map
    mp_offset: int
    target_slot: int = -1  # the map slot that absorbed the query map
    # the absorbed map's old -> compacted arena remaps (-1 = dropped)
    kf_remap: object = None
    mp_remap: object = None
    kf_pair: tuple = None  # (query arena in the fused map, matched arena)


@dataclass
class MapMatcher:
    """Server-wide cross-map matcher.  The shared bank keeps keyframe
    (map_slot, k) at row map_slot * kf_capacity + k (the reference shares one
    KeyFrameDatabase across all maps, ServerSystem.cpp:49)."""

    cfg: SystemConfig
    cam: object
    vocab: bow.Vocabulary
    n_slots: int
    kf_capacity: int
    db: kdb.KeyFrameDB = None
    rng: Optional[torch.Generator] = None
    stats: dict = field(default_factory=lambda: {"bow_transforms": 0, "sim3_attempts": 0})

    def __post_init__(self):
        # the bank lives with the vocabulary, on the server's device
        if self.db is None:
            self.db = kdb.empty_db(self.n_slots * self.kf_capacity, self.vocab.n_words,
                                   self.vocab.words.device)
        if self.rng is None:
            self.rng = torch.Generator(device=self.db.vectors.device).manual_seed(777)

    def global_idx(self, map_slot: int, kf_idx: int) -> int:
        return map_slot * self.kf_capacity + kf_idx

    def insert_keyframe(self, map_slot: int, m: ms.MapState, kf_idx: int):
        vec, _ = bow.transform(self.vocab, m.kfs.desc[kf_idx], m.kfs.feat_valid[kf_idx])
        self.stats["bow_transforms"] += 1
        self.db = kdb.add(self.db, self.global_idx(map_slot, kf_idx), vec, map_slot)

    def insert_keyframes(self, map_slot: int, m: ms.MapState, kf_idxs):
        """Batched registration: one BoW transform call and one scatter."""
        if len(kf_idxs) == 0:
            return
        idx = torch.as_tensor(list(kf_idxs), dtype=torch.long, device=m.device)
        vecs, _ = bow.transform_batch(self.vocab, m.kfs.desc[idx], m.kfs.feat_valid[idx])
        self.stats["bow_transforms"] += 1
        self.db = kdb.add(self.db, [self.global_idx(map_slot, int(k)) for k in kf_idxs], vecs,
                          map_slot)

    def retire_map(self, map_slot: int):
        """Drop a map's rows (after a merge absorbed it)."""
        lo = map_slot * self.kf_capacity
        mask = torch.zeros(self.db.capacity, dtype=torch.bool, device=self.db.valid.device)
        mask[lo:lo + self.kf_capacity] = True
        self.db = kdb.erase(self.db, mask)

    def grow(self, new_kf_capacity: int):
        """Widen the per-slot stride when a map arena grows (rows move from
        slot*old + k to slot*new + k; arena indices unchanged)."""
        if new_kf_capacity <= self.kf_capacity:
            return
        self.db = kdb.regrid(self.db, self.kf_capacity, new_kf_capacity, self.n_slots)
        self.kf_capacity = new_kf_capacity

    def detect(self, map_slot: int, m: ms.MapState, kf_idx: int, maps: dict = None):
        """Cross-map candidates of one keyframe, best score first:
        [(map_slot_b, kf_b, score), ...].  ``maps``: the OTHER maps by slot;
        their covisibility graphs drive the group accumulation."""
        if int(m.kfs.kf_id[kf_idx]) < self.cfg.placerec.start_map_matching_after_kf:
            return []
        self.stats["bow_transforms"] += 1
        vec, _ = bow.transform(self.vocab, m.kfs.desc[kf_idx], m.kfs.feat_valid[kf_idx])
        all_maps = dict(maps or {})
        all_maps[map_slot] = m
        cand_mask, scores = kdb.detect_map_match_candidates(
            self.db, vec, map_slot, self._global_covis(all_maps), min_score=0.015)
        cand, s_np = cand_mask.cpu().numpy(), scores.cpu().numpy()
        out = [(int(g) // self.kf_capacity, int(g) % self.kf_capacity, float(s_np[g]))
               for g in np.where(cand)[0]]
        out.sort(key=lambda x: -x[2])
        return out

    def _global_covis(self, maps: dict, top_k: int = 10):
        """Sparse global covisibility over the shared bank's index space
        (slot * stride + arena idx): each row's top-k covisible neighbours
        from the real per-map covisibility matrices (a row with none points
        at itself, a no-op in the group accumulation)."""
        n = self.db.capacity
        dev = self.db.vectors.device
        nbr_g = torch.arange(n, dtype=torch.int32, device=dev)[:, None].repeat(1, top_k)
        for slot, mm in maps.items():
            W = ms.covisibility_matrix(mm)
            lo = slot * self.kf_capacity
            K = min(W.shape[0], self.kf_capacity)
            w, nbr = top_k_stable(W[:K, :K], top_k)
            self_idx = torch.arange(K, device=dev)[:, None]
            nbr_g[lo:lo + K] = torch.where(w > 0, nbr + lo, self_idx + lo).to(torch.int32)
        return nbr_g

    def try_match(self, map_slot_a: int, m_a: ms.MapState, kf_idx: int, maps: dict,
                  sample=None):
        """Attempt a cross-map match and merge for keyframe ``kf_idx`` of map
        A.  ``maps``: {map_slot: MapState}; ``sample``: as ``estimate_sim3``'s
        ``idx`` (else ``rng``).  Returns a MergeResult (map A absorbed into
        the matched map B, A's entities appended to B's arena) or None."""
        for slot_b, kf_b, _ in self.detect(map_slot_a, m_a, kf_idx, maps)[:3]:
            if slot_b == map_slot_a or slot_b not in maps:
                continue
            m_b = maps[slot_b]
            dev = m_b.device
            # trial union by plain concatenation (identity gauge); the TARGET
            # map is spliced as it is, so its arena indices stay valid
            trial = ms.merge_maps(m_b, m_a, 1.0, torch.eye(3, device=dev),
                                  torch.zeros(3, device=dev))
            kf_off = int(m_b.next_kf) + kf_idx_after_compact(m_a, kf_idx)
            mp_off = int(m_b.next_mp)
            self.stats["sim3_attempts"] += 1
            est = estimate_sim3(trial, kf_off, kf_b, self.cam, self.cfg, idx=sample,
                                generator=self.rng)
            if not bool(est["success"]):
                continue
            n_total, loop_mask, t_idx, okm = guided_projection_count(
                trial, kf_off, kf_b, est["S_qc"], self.cam, self.cfg,
                ms.covisibility_matrix(trial))
            if int(n_total) < self.cfg.placerec.total_matches_thres:
                continue
            # the real fusion with the gauge Sim3
            S_ba = gauge_from_match(trial, kf_off, kf_b, est["S_qc"])
            fused = ms.merge_maps(m_b, m_a, S_ba.s, S_ba.R, S_ba.t)
            # the merge edge is measured from the FUSED poses (merge_maps
            # flattened A's scale into SE3)
            kfs_f = fused.kfs
            T_q = SE3(R=kfs_f.R_cw[kf_off], t=kfs_f.t_cw[kf_off]).to_sim3()
            T_c = SE3(R=kfs_f.R_cw[kf_b], t=kfs_f.t_cw[kf_b]).to_sim3()
            fused, _, info = correct_loop(fused, kf_off, kf_b, T_q.compose(T_c.inverse()),
                                          self.cam, self.cfg, loop_mask=loop_mask,
                                          gp_t_idx=t_idx, gp_okm=okm)
            dropped = int(info["covis_edges_dropped"])
            if dropped > 0:
                print(f"[merge] essential graph dropped {dropped} of "
                      f"{int(info['covis_edges'])} strong covisibility edges")
            kf_remap, mp_remap = ms.compaction_remap(m_a)
            return MergeResult(fused=fused, S_from_to=S_ba, kf_offset=int(m_b.next_kf),
                               mp_offset=mp_off, target_slot=slot_b, kf_remap=kf_remap,
                               mp_remap=mp_remap, kf_pair=(kf_off, kf_b))
        return None


def kf_idx_after_compact(m: ms.MapState, kf_idx: int) -> int:
    """Arena index of a keyframe after ``compact_map`` (merge_maps compacts
    the absorbed map): its rank among the alive keyframes."""
    keep = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
    return int(np.sum(keep[:kf_idx]))
