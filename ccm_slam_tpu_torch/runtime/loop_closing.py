"""Loop closing: detection, Sim(3) estimation, map correction, pose graph
(PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/loop_closing.py`` (the reference's
``LoopFinder``, cslam/src/LoopFinder.cpp):

  DetectLoop (:103-229)   -> LoopFinder.detect(): BoW candidates +
                             covisibility consistency over consecutive detections
  ComputeSim3 (:231-405)  -> estimate_sim3() (``match_brute``, i.e. the
                             ``hamming_top2`` kernel, then batched Sim3 RANSAC
                             and the pair refinement) + guided_projection_count()
  CorrectLoop (:407-707)  -> correct_loop(): Sim3-propagate the query's
                             neighborhood, fuse duplicate landmarks, optimize
                             the Sim(3) essential graph

Every stage is a function MapState -> MapState on one device; the
consistency bookkeeping stays on the host, as in the reference, and each
host read is counted in ``LoopFinder.stats["host_reads"]``.

Randomness: the RANSAC samples of ``estimate_sim3`` are an input (``idx``:
the [H,3] indices, or a callable that draws them from the match mask), else
drawn from a ``torch.Generator``; ``LoopFinder.rng`` is seeded
``1234 + map_id`` (the reference seeds ``PRNGKey(1234 + map_id)``).  Ties:
``top_k_stable`` for the covisibility neighbors and the essential graph's
covisibility edges, first-index argmax elsewhere (``jax.lax.top_k`` and
``jnp.argmax`` order).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..models import keyframe_db as kdb
from ..models import map_store as ms
from ..ops import bow, matching
from ..ops.hamming import top_k_stable
from ..ops.initializer import draw_samples
from ..solvers import pose_graph as pg
from ..solvers import sim3 as sim3_solver
from ..solvers.reproj import level_sigma2
from ..utils.lie import SE3, Sim3, orthonormalize
from . import mapping


def _where(mask, a: Sim3, b: Sim3) -> Sim3:
    """Per-vertex choice between two batched Sim3s by a [K] mask."""
    return Sim3(s=torch.where(mask, a.s, b.s), R=torch.where(mask[:, None, None], a.R, b.R),
                t=torch.where(mask[:, None], a.t, b.t))


def _cat(*S: Sim3) -> Sim3:
    return Sim3(s=torch.cat([x.s for x in S]), R=torch.cat([x.R for x in S]),
                t=torch.cat([x.t for x in S]))


# ---------------------------------------------------------------------------
# Sim3 estimation between two keyframes
# ---------------------------------------------------------------------------


def estimate_sim3(m: ms.MapState, kf_q, kf_c, cam, cfg: SystemConfig, idx=None,
                  generator=None):
    """Match the landmarks of the query and candidate keyframes and estimate
    S_qc (candidate camera -> query camera similarity).

    ``idx``: the RANSAC samples [H,3], or a callable taking the match mask
    [N] and returning them (else drawn from ``generator``).  The match count
    is read on the host once the samples are drawn: below
    ``placerec.matches_thres`` the attempt fails whatever RANSAC finds, so
    the RANSAC and the refinement are skipped (the Sim3 is the identity, no
    inlier).  Returns dict (success, S_qc, n_matches, n_inliers, matched_mp
    [N])."""
    kfs, mps = m.kfs, m.mps
    N = kfs.n_feat
    dev = kfs.R_cw.device
    q = torch.as_tensor(kf_q, device=dev).long()
    c = torch.as_tensor(kf_c, device=dev).long()

    def kf_mp_state(k):
        mp = kfs.mp_idx[k]
        mpc = mp.clamp(0, mps.capacity - 1).long()
        ok = (mp >= 0) & mps.valid[mpc] & ~mps.bad[mpc] & kfs.feat_valid[k]
        return mp, mpc, ok

    _, mpc_q, ok_q = kf_mp_state(q)
    mp_c, mpc_c, ok_c = kf_mp_state(c)
    q_idx, _, okm = matching.match_brute(
        kfs.desc[q], ok_q.contiguous(), kfs.desc[c], ok_c.contiguous(),
        th_dist=matching.TH_LOW, nn_ratio=0.75, q_angle=kfs.angle[q], t_angle=kfs.angle[c])
    n_matches = torch.sum(okm)

    # camera-frame 3D of the matched landmark in each keyframe
    tgt = q_idx.clamp(0, N - 1)
    Xq = (kfs.R_cw[q] @ mps.pos[mpc_q].T).T + kfs.t_cw[q]
    Xc = ((kfs.R_cw[c] @ mps.pos[mpc_c].T).T + kfs.t_cw[c])[tgt]
    uv_q, uv_c = kfs.xy[q], kfs.xy[c][tgt]
    sf = cfg.extractor.scale_factor
    s2_q = level_sigma2(kfs.octave[q], sf)
    s2_c = level_sigma2(kfs.octave[c], sf)[tgt]
    H = cfg.placerec.max_iterations
    if callable(idx):
        idx = idx(okm)
    if idx is None:
        idx = draw_samples(okm, H, 3, generator=generator)
    if int(n_matches) < cfg.placerec.matches_thres:
        return {"success": torch.zeros((), dtype=torch.bool, device=dev),
                "S_qc": Sim3.identity(device=dev), "n_matches": n_matches,
                "n_inliers": torch.zeros((), dtype=torch.int64, device=dev),
                "matched_mp": torch.full((N,), ms.NO_MP, dtype=torch.int32, device=dev)}
    S_qc, inl, _ = sim3_solver.ransac_sim3(
        Xq, Xc, uv_q, uv_c, okm, 9.210 * s2_q, 9.210 * s2_c, cam.fx, cam.fy, cam.cx, cam.cy,
        n_hypotheses=H, idx=idx)
    S_ref, inl2, n_in2 = sim3_solver.optimize_sim3(
        S_qc, Xq, Xc, uv_q, uv_c, inl, s2_q, s2_c, cam.fx, cam.fy, cam.cx, cam.cy)
    success = (n_matches >= cfg.placerec.matches_thres) & (n_in2 >= cfg.placerec.inliers_thres)
    return {
        "success": success,
        "S_qc": S_ref,
        "n_matches": n_matches,
        "n_inliers": n_in2,
        "matched_mp": torch.where(okm & inl2, mp_c[tgt], ms.NO_MP),  # per query feature
    }


def guided_projection_count(m: ms.MapState, kf_q, kf_c, S_qc: Sim3, cam, cfg: SystemConfig,
                            covis_W):
    """Project the loop neighborhood's landmarks (the candidate's and its 10
    most covisible keyframes') into the query keyframe through S_qc and count
    the matches (SearchByProjection with the Sim3 cloud, LoopFinder.cpp:
    355-377).  Returns (n_total, loop_mp_mask [M], t_idx [M], matched [M])."""
    kfs, mps = m.kfs, m.mps
    dev = kfs.R_cw.device
    q = torch.as_tensor(kf_q, device=dev).long()
    c = torch.as_tensor(kf_c, device=dev).long()
    Mc = mps.capacity
    nbr_idx, nbr_w, _ = ms.covis_neighbors(covis_W, c, 10, min_weight=1)
    rows = kfs.mp_idx[torch.cat([c.reshape(1), nbr_idx])]  # [11, N]
    use = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nbr_w > 0])
    loop_mask = ms._bool_at(torch.zeros(Mc, dtype=torch.bool, device=dev),
                            rows.clamp(0, Mc - 1).reshape(-1),
                            ((rows >= 0) & use[:, None]).reshape(-1), "amax")
    loop_mask = loop_mask & mps.valid & ~mps.bad

    # S_qw = S_qc o T_cw(candidate): world -> query-camera similarity
    S_qw = S_qc.compose(SE3(R=kfs.R_cw[c], t=kfs.t_cw[c]).to_sim3())
    Xq = S_qw.apply(mps.pos)
    z = Xq[:, 2]
    uv = torch.stack([cam.fx * Xq[:, 0] / torch.clamp(z, min=1e-6) + cam.cx,
                      cam.fy * Xq[:, 1] / torch.clamp(z, min=1e-6) + cam.cy], -1)
    q_ok = loop_mask & (z > 0) & cam.in_bounds(uv)
    sf = cfg.extractor.scale_factor
    pred_oct = matching.predict_octave(torch.linalg.norm(Xq, dim=-1), mps.max_dist * S_qw.s, sf,
                                       cfg.extractor.n_levels)
    radius = 10.0 * torch.pow(torch.tensor(sf, dtype=torch.float32, device=dev),
                              pred_oct.to(torch.float32))
    t_idx, dmin, okm = matching.match_in_window(
        uv, mps.desc, q_ok, kfs.xy[q], kfs.desc[q], kfs.feat_valid[q],
        radius=radius, th_dist=matching.TH_LOW, nn_ratio=1.0)
    okm = matching._unique_target(t_idx, dmin, okm, kfs.n_feat)
    return torch.sum(okm), loop_mask, t_idx, okm


# ---------------------------------------------------------------------------
# Loop correction
# ---------------------------------------------------------------------------


def _fuse_loop(m_work, W, q, loop_mask, gp_t_idx, gp_okm, cam, cfg):
    """Landmark fusion across the loop (LoopFinder.cpp:619-644 + 709-734):
    the guided projection's matches replace the query's landmarks (a free
    feature takes the loop landmark, an occupied one merges into it), then
    the loop landmarks are fused into the query and its 8 most covisible
    keyframes with the loop landmark winning."""
    kfs, mps = m_work.kfs, m_work.mps
    Mcap, N = mps.capacity, kfs.n_feat
    dev = kfs.R_cw.device
    lm_ids = torch.arange(Mcap, dtype=torch.int32, device=dev)
    f_idx = gp_t_idx.clamp(0, N - 1).long()
    row = kfs.mp_idx[q]
    existing = row[f_idx]
    okg = gp_okm & loop_mask
    free_hit = okg & (existing < 0)
    tsafe = torch.where(free_hit, f_idx, N - 1)
    row = ms._add_at(row, (tsafe,), torch.where(free_hit, lm_ids - row[tsafe], 0), free_hit)
    m_work = m_work.replace(kfs=kfs.replace(mp_idx=ms._set_row(kfs.mp_idx, q, row)))
    dup = okg & (existing >= 0) & (existing != lm_ids)
    loser = torch.where(dup, existing.clamp(0, Mcap - 1), -1)
    winner = torch.where(dup, lm_ids, -1)
    m_work = ms.replace_mappoints(m_work, loser, winner)
    # SearchAndFuse into the neighborhood (the query + its top covisible)
    nbr_idx, nbr_w, _ = ms.covis_neighbors(W, q, 8, min_weight=1)
    m_work, _, _ = mapping.fuse_into(m_work, q, loop_mask, cam, cfg, radius_base=4.0,
                                     prefer_candidate=True)
    for i in range(8):
        m_work, _, _ = mapping.fuse_into(m_work, nbr_idx[i], loop_mask & (nbr_w[i] > 0), cam,
                                         cfg, radius_base=4.0, prefer_candidate=True)
    return m_work


def covis_edges(W, alive, min_feats: int, E_cov: int):
    """The essential graph's strong covisibility edges (weight >= min_feats,
    alive pairs i < j) as a bounded list: the top ``E_cov`` pairs by weight,
    the lower flat index first among equal weights (``jax.lax.top_k``'s
    order, also for the weight-0 padding).  Returns (i [E_cov], j [E_cov],
    valid [E_cov], n_strong); the count beyond the cap is the caller's to
    surface (no silent caps)."""
    K = W.shape[0]
    strong = torch.triu((W >= min_feats) & alive[:, None] & alive[None, :], 1)
    topw, topi = top_k_stable(torch.where(strong, W, 0).reshape(-1), E_cov)
    return ((topi // K).to(torch.int32), (topi % K).to(torch.int32), topw > 0,
            torch.sum(strong))


def correct_loop(m: ms.MapState, kf_q, kf_c, S_qc: Sim3, cam, cfg: SystemConfig,
                 ess_iters: int = 20, loop_mask=None, gp_t_idx=None, gp_okm=None):
    """Sim3-correct the query's neighborhood, fuse the loop's landmarks, then
    optimize the Sim(3) essential graph over the whole map (CorrectLoop +
    OptimizeEssentialGraphLoopClosure).  Returns (map', cost, info)."""
    kfs, mps = m.kfs, m.mps
    K = kfs.capacity
    dev = kfs.R_cw.device
    q = torch.as_tensor(kf_q, device=dev).long()
    c = torch.as_tensor(kf_c, device=dev).long()
    alive = kfs.valid & ~kfs.bad

    W = ms.covisibility_matrix(m)
    parent = ms.spanning_tree(m, W)

    # --- corrected Sim3 poses for the query's neighborhood -----------------
    S_qw_corr = S_qc.compose(SE3(R=kfs.R_cw[c], t=kfs.t_cw[c]).to_sim3())
    T_all = SE3(R=kfs.R_cw, t=kfs.t_cw)
    T_qw = SE3(R=kfs.R_cw[q], t=kfs.t_cw[q])
    nbhd = ms._set_row(W[q] > 0, q, True) & alive
    # S_iw_corr = T_iq o S_qw_corr,  T_iq = T_iw o T_qw^-1
    S_corr = T_all.compose(T_qw.inverse()).to_sim3().compose(Sim3(
        s=S_qw_corr.s.expand(K), R=S_qw_corr.R.expand(K, 3, 3), t=S_qw_corr.t.expand(K, 3)))
    S_pre = T_all.to_sim3()

    # landmark correction: X' = S_corr_ref^-1(S_pre_ref(X)) in the neighborhood
    ref = mps.ref_kf.clamp(0, K - 1).long()
    mp_move = mps.valid & ~mps.bad & nbhd[ref]
    X_new = S_corr[ref].inverse().apply(S_pre[ref].apply(mps.pos))
    pos2 = torch.where(mp_move[:, None], X_new, mps.pos)

    T_corr = S_corr.to_se3_scaled()
    kfs_work = kfs.replace(
        R_cw=torch.where(nbhd[:, None, None], orthonormalize(T_corr.R), kfs.R_cw),
        t_cw=torch.where(nbhd[:, None], T_corr.t, kfs.t_cw))
    m_work = m.replace(kfs=kfs_work, mps=mps.replace(pos=pos2))
    if loop_mask is not None:
        m_work = _fuse_loop(m_work, W, q, loop_mask, gp_t_idx, gp_okm, cam, cfg)
        # refresh the derived graph structure after fusion
        W = ms.covisibility_matrix(m_work)
        parent = ms.spanning_tree(m_work, W)
    mps = m_work.mps
    pos2 = mps.pos
    ref = mps.ref_kf.clamp(0, K - 1).long()

    # --- essential graph ----------------------------------------------------
    # vertices: corrected Sim3 in the neighborhood, current poses else; edges:
    # spanning tree + strong covisibility + the new loop edge + every loop
    # edge on record, measured from the pre-correction poses (the loop edge
    # by the Sim3 estimate)
    S_vert = _where(nbhd, S_corr, S_pre)
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    e1_j = parent.clamp(0, K - 1)
    e1_valid = (parent >= 0) & alive & alive[e1_j.long()]
    S1 = pg.relative_sim3(S_pre, S_pre[e1_j.long()])

    E_cov = K * 4
    e2_i, e2_j, e2_valid, n_strong = covis_edges(W, alive, cfg.opt.ess_graph_min_feats, E_cov)
    S2 = pg.relative_sim3(S_pre[e2_i.long()], S_pre[e2_j.long()])

    S3 = Sim3(s=S_qc.s.reshape(1), R=S_qc.R.reshape(1, 3, 3), t=S_qc.t.reshape(1, 3))

    L = kfs.loop_edges.shape[1]
    e4_i = torch.repeat_interleave(ar, L)
    le_flat = kfs.loop_edges.reshape(-1)
    e4_j = le_flat.clamp(0, K - 1)
    e4_valid = ((le_flat >= 0) & alive[e4_i.long()] & alive[e4_j.long()] & (e4_i < e4_j))
    S4 = pg.relative_sim3(S_pre[e4_i.long()], S_pre[e4_j.long()])

    one = torch.ones(1, dtype=torch.bool, device=dev)
    prob = pg.PoseGraphProblem(
        S_w=S_vert,
        fixed=ar == c,  # the loop-match keyframe anchors the graph
        vert_valid=alive,
        i_idx=torch.cat([ar, e2_i, q.to(torch.int32).reshape(1), e4_i]),
        j_idx=torch.cat([e1_j, e2_j, c.to(torch.int32).reshape(1), e4_j]),
        S_meas=_cat(S1, S2, S3, S4),
        edge_valid=torch.cat([e1_valid, e2_valid, one, e4_valid]),
        weight=torch.ones(K + E_cov + 1 + K * L, dtype=torch.float32, device=dev),
    )
    S_opt, cost = pg.optimize_pose_graph(prob, iters=ess_iters)

    # --- apply: poses [R, t/s]; landmarks through their reference keyframe --
    T_new = S_opt.to_se3_scaled()
    kfs = m_work.kfs  # carries the fused forward links
    kfs2 = kfs.replace(
        R_cw=torch.where(alive[:, None, None], orthonormalize(T_new.R), kfs.R_cw),
        t_cw=torch.where(alive[:, None], T_new.t, kfs.t_cw),
        pose_version=kfs.pose_version + alive.to(torch.int32),
    )
    kfs2, le_dropped = ms.add_loop_edge(kfs2, q, c)
    # X'' = S_opt_ref^-1(S_vert_ref(X'))
    mp_ok = mps.valid & ~mps.bad & alive[ref]
    X_final = S_opt[ref].inverse().apply(S_vert[ref].apply(pos2))
    mps2 = mps.replace(pos=torch.where(mp_ok[:, None], X_final, pos2),
                       pos_version=mps.pos_version + 1)
    info = {
        "covis_edges": n_strong,
        "covis_edges_dropped": torch.clamp(n_strong - E_cov, min=0),
        "loop_edges_dropped": le_dropped,
    }
    return m.replace(kfs=kfs2, mps=mps2), cost, info


# ---------------------------------------------------------------------------
# Host orchestration with consistency bookkeeping
# ---------------------------------------------------------------------------


@dataclass
class LoopFinder:
    """Per-map loop detector/corrector (host orchestration).

    Consistency rule (LoopFinder::DetectLoop:152-215): a candidate's
    covisibility group must share a member with groups of
    ``covisibility_consistency_th`` consecutive detections before the Sim3
    is attempted."""

    cfg: SystemConfig
    cam: object
    vocab: bow.Vocabulary
    db: kdb.KeyFrameDB
    map_id: int = 0
    last_loop_kf_id: int = -10**9
    prev_groups: list = field(default_factory=list)  # [(group set, count)]
    rng: Optional[torch.Generator] = None
    stats: dict = field(default_factory=lambda: {
        "host_reads": 0, "bow_transforms": 0, "sim3_attempts": 0})

    def __post_init__(self):
        if self.rng is None:
            self.rng = torch.Generator(device=self.db.vectors.device).manual_seed(
                1234 + self.map_id)

    def _int(self, x) -> int:
        self.stats["host_reads"] += 1
        return int(x)

    def _bool(self, x) -> bool:
        self.stats["host_reads"] += 1
        return bool(x)

    def _host(self, x) -> np.ndarray:
        self.stats["host_reads"] += 1
        return x.cpu().numpy()

    def insert_keyframe(self, m: ms.MapState, kf_idx: int):
        vec, _ = bow.transform(self.vocab, m.kfs.desc[kf_idx], m.kfs.feat_valid[kf_idx])
        self.stats["bow_transforms"] += 1
        self.db = kdb.add(self.db, kf_idx, vec, self.map_id)
        return vec

    def detect(self, m: ms.MapState, kf_idx: int, covis_W):
        """The consistent-enough candidate arena indices (a list)."""
        # register the keyframe first: early keyframes are exactly the
        # candidates later queries must find (Mapping.cpp:173)
        vec = self.insert_keyframe(m, kf_idx)
        kf_id = self._int(m.kfs.kf_id[kf_idx])
        if self._int(torch.sum(m.kfs.valid & ~m.kfs.bad)) < 10:
            return []
        if kf_id < self.last_loop_kf_id + self.cfg.placerec.new_loop_thres:
            return []
        min_score, has_nbr = kdb.min_covisible_score(self.db, vec, kf_idx, covis_W)
        if not self._bool(has_nbr):
            return []
        cand_mask, _ = kdb.detect_loop_candidates(self.db, vec, kf_idx, self.map_id, covis_W,
                                                  min_score)
        cand = np.where(self._host(cand_mask))[0]
        if len(cand) == 0:
            self.prev_groups = []
            return []

        # covisibility consistency over consecutive detections
        Wnp = self._host(covis_W)
        consistent_enough = []
        new_groups = []
        for c in cand:
            group = set(np.where(Wnp[c] > 0)[0].tolist()) | {int(c)}
            best_count = 0
            for prev, count in self.prev_groups:
                if group & prev:
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count + 1 >= self.cfg.placerec.covisibility_consistency_th:
                consistent_enough.append(int(c))
        self.prev_groups = new_groups
        return consistent_enough

    def try_close(self, m: ms.MapState, kf_idx: int, sample=None):
        """The loop pipeline for one keyframe.  ``sample``: a callable that
        draws each attempt's RANSAC samples from its match mask (else
        ``rng``).  Returns (map, closed?)."""
        covis_W = ms.covisibility_matrix(m)
        candidates = self.detect(m, kf_idx, covis_W)
        for cand in candidates[:3]:
            self.stats["sim3_attempts"] += 1
            est = estimate_sim3(m, kf_idx, cand, self.cam, self.cfg, idx=sample,
                                generator=self.rng)
            self.stats["host_reads"] += 1  # estimate_sim3's match count
            if not self._bool(est["success"]):
                continue
            n_total, loop_mask, t_idx, okm = guided_projection_count(
                m, kf_idx, cand, est["S_qc"], self.cam, self.cfg, covis_W)
            if self._int(n_total) < self.cfg.placerec.total_matches_thres:
                continue
            # no silent caps: the guided projection sees the candidate's top-10
            # covisible neighbors only (LoopFinder.cpp:355)
            n_nbr = self._int(torch.sum(covis_W[cand] > 0))
            if n_nbr > 10:
                print(f"[loop] guided projection truncated candidate vicinity {n_nbr} -> 10 "
                      "neighbors")
            m, _, info = correct_loop(m, kf_idx, cand, est["S_qc"], self.cam, self.cfg,
                                      loop_mask=loop_mask, gp_t_idx=t_idx, gp_okm=okm)
            dropped = self._int(info["covis_edges_dropped"])
            if dropped > 0:
                n_cov = self._int(info["covis_edges"])
                print(f"[loop] essential graph kept top {n_cov - dropped} of {n_cov} strong "
                      "covisibility edges")
            le_dropped = self._int(info["loop_edges_dropped"])
            if le_dropped > 0:
                print(f"[loop] loop-edge table full on an endpoint: {le_dropped} direction(s) "
                      "dropped (raise map_store.MAX_LOOP_EDGES)")
            self.last_loop_kf_id = self._int(m.kfs.kf_id[kf_idx])
            self.prev_groups = []
            return m, True
        return m, False
