"""Local mapping, the client part: landmark creation, culling, fusion and
windowed local BA (PyTorch).

Counterpart of the client side of ``ccm_slam_tpu/runtime/mapping.py`` (the
reference's ``LocalMapping::RunClient``, cslam/src/Mapping.cpp:42-121): a
deterministic step run right after each keyframe insertion.

  MapPointCullingClient (:704)   -> cull_mappoints()
  CreateNewMapPoints (:284-469)  -> triangulate_new_points()
  SearchInNeighbors (:471-547)   -> fuse_neighbors()   (fuse_into, _fuse_subset)
  LocalBundleAdjustmentClient    -> local_ba()

Redundant-keyframe culling (KeyFrameCullingV3, :771-863), which the
single-agent standalone system and the server run: ``keyframe_redundancy()``
and ``cull_redundant_keyframes()``.  The server's landmark culling
(MapPointCullingServer, :738-770) is ``cull_mappoints_server()``; the
client's local-map bound (Map::MapTrimming) is ``trim_keyframes()``.
``jax.lax.top_k`` becomes ``top_k_stable`` (lower index first among
equals).
"""

from __future__ import annotations

import torch

from ..config import SystemConfig
from ..models import map_store as ms
from ..ops import initializer as init_ops
from ..ops import matching
from ..ops.hamming import top_k_stable
from ..solvers import ba
from ..solvers.reproj import level_sigma2
from .tracking import _project

NO_MP = ms.NO_MP


def cull_mappoints(m: ms.MapState, cur_kf_id, cfg: SystemConfig):
    """Recent-landmark culling (MapPointCullingClient): erase landmarks with
    found/visible < 0.25, or older than 2 KFs with <= 2 observations."""
    mps = m.mps
    alive = mps.valid & ~mps.bad
    found_ratio = mps.n_found.to(torch.float32) / torch.clamp(
        mps.n_visible.to(torch.float32), min=1.0)
    age = int(cur_kf_id) - mps.first_kf_id
    kill = alive & (age <= 3) & ((found_ratio < 0.25) | ((age >= 2) & (mps.obs_n <= 2)))
    return ms.erase_mappoints(m, kill), torch.sum(kill)


def cull_mappoints_server(m: ms.MapState, cfg: SystemConfig):
    """Server-side recent-landmark culling (MapPointCullingServer,
    cslam/src/Mapping.cpp:738-770): landmarks at most 4 ingested keyframes
    old whose found ratio fell below 0.25, or that are >= 3 old with <= 3
    observations, are retired.  Age is the keyframe cursor minus the
    landmark's arrival stamp.  Returns (map, n_culled)."""
    mps = m.mps
    alive = mps.valid & ~mps.bad
    age = m.next_kf - torch.clamp(mps.first_kf_id, min=0)
    found_ratio = mps.n_found.to(torch.float32) / torch.clamp(
        mps.n_visible.to(torch.float32), min=1.0)
    kill = alive & (age <= 4) & ((found_ratio < 0.25) | ((age >= 3) & (mps.obs_n <= 3)))
    return ms.erase_mappoints(m, kill), torch.sum(kill)


def trim_keyframes(m: ms.MapState, cfg: SystemConfig, trimmable=None):
    """Client local-map bound (Map::MapTrimming, cslam/src/Map.cpp:857-1063):
    keep the newest ``local_map_size`` keyframes by insertion order, erase
    the rest.  ``trimmable`` [K] bool (CanBeForgotten: sent AND acked,
    ``communicator.trimmable_mask``): keyframes beyond the window that are
    not trimmable yet are kept and counted in n_held.  Landmarks left with
    no observation die with them.  Returns (map, n_trimmed, n_held)."""
    kfs = m.kfs
    alive = kfs.valid & ~kfs.bad
    order = torch.where(alive, kfs.insert_order, -1)
    newer = torch.sum((order[:, None] < order[None, :]).to(torch.int32), dim=1)
    over = alive & ~(newer < cfg.mapping.local_map_size)
    if trimmable is None:
        kill = over
        n_held = torch.zeros((), dtype=torch.int64, device=alive.device)
    else:
        kill = over & trimmable
        n_held = torch.sum(over & ~trimmable)
    m = ms.erase_keyframes(m, kill)
    orphan = m.mps.valid & ~m.mps.bad & (m.mps.obs_n == 0)
    return ms.erase_mappoints(m, orphan), torch.sum(kill), n_held


def _skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def triangulate_new_points(m: ms.MapState, kf_idx, cam, cfg: SystemConfig,
                           n_neighbors: int = 10, next_mp_id=None, client_id=0):
    """Epipolar search + triangulation against the top covisible neighbors
    (CreateNewMapPoints).  Returns (map', n_created)."""
    N = m.kfs.n_feat
    dev = m.kfs.R_cw.device
    sf = cfg.extractor.scale_factor
    sf_t = torch.tensor(sf, dtype=torch.float32, device=dev)
    k = torch.as_tensor(kf_idx, device=dev).long()
    row = ms.covis_row(m, k)
    nbr_w, nbr_idx = top_k_stable(row, n_neighbors)

    kfs = m.kfs
    R1, t1 = kfs.R_cw[k], kfs.t_cw[k]
    O1 = -(R1.T @ t1)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    if next_mp_id is None:
        next_mp_id = m.next_mp
    K_mat = cam.K
    Kinv = torch.linalg.inv(K_mat)
    cid = torch.full((N,), int(client_id), dtype=torch.int32, device=dev)

    for i in range(n_neighbors):
        nb, w_nb = nbr_idx[i], nbr_w[i]
        kfs = m.kfs
        R2, t2 = kfs.R_cw[nb], kfs.t_cw[nb]
        O2 = -(R2.T @ t2)

        # baseline / scene-depth ratio gate (Mapping.cpp:316-325)
        baseline = torch.linalg.norm(O2 - O1)
        mp_nb = kfs.mp_idx[nb]
        z_nb = ((R2 @ m.mps.pos[mp_nb.clamp(0, m.mps.capacity - 1).long()].T).T + t2)[:, 2]
        med_depth = ms.nanmedian(torch.where(mp_nb >= 0, z_nb, float("nan")))
        med_depth = torch.where(torch.isfinite(med_depth) & (med_depth > 0), med_depth, 1.0)
        nb_ok = (w_nb > 0) & (nb != k) & (baseline / med_depth > 0.01)

        # Xc1 = R12 Xc2 + t12: x1^T F x2 = 0 for F = K^-T [t12]x R12 K^-1
        R12 = R1 @ R2.T
        t12 = t1 - (R12 @ t2)
        F12 = Kinv.T @ (_skew(t12) @ R12) @ Kinv

        free1 = kfs.feat_valid[k] & (kfs.mp_idx[k] < 0)
        free2 = kfs.feat_valid[nb] & (kfs.mp_idx[nb] < 0)
        s2_1 = level_sigma2(kfs.octave[k], sf)
        s2_2 = level_sigma2(kfs.octave[nb], sf)
        idx2, _, okm = matching.search_for_triangulation(
            kfs.desc[k], free1 & nb_ok, kfs.xy[k], kfs.angle[k], s2_1,
            kfs.desc[nb], free2, kfs.xy[nb], kfs.angle[nb], s2_2, F12,
        )
        idx2c = idx2.clamp(0, N - 1).long()

        P1 = K_mat @ torch.cat([R1, t1[:, None]], 1)
        P2 = K_mat @ torch.cat([R2, t2[:, None]], 1)
        p1 = kfs.xy[k]
        p2 = kfs.xy[nb][idx2c]
        X = init_ops.triangulate(P1, P2, p1, p2)

        # acceptance gates (Mapping.cpp:388-457)
        Xc1 = (R1 @ X.T).T + t1
        Xc2 = (R2 @ X.T).T + t2
        r1 = _project(cam, Xc1, 1e-9) - p1
        r2 = _project(cam, Xc2, 1e-9) - p2
        ray1, ray2 = X - O1, X - O2
        d1 = torch.linalg.norm(ray1, dim=-1)
        d2 = torch.linalg.norm(ray2, dim=-1)
        cos_par = torch.sum(ray1 * ray2, -1) / torch.clamp(d1 * d2, min=1e-12)
        ratio_dist = d2 / torch.clamp(d1, min=1e-9)
        oct1 = kfs.octave[k]
        oct2 = kfs.octave[nb][idx2c]
        ratio_oct = torch.pow(sf_t, (oct1 - oct2).to(torch.float32))
        ratio_factor = 1.5 * sf
        good = (okm & nb_ok & torch.all(torch.isfinite(X), -1) & (Xc1[:, 2] > 0)
                & (Xc2[:, 2] > 0) & (cos_par < 0.9998)
                & (torch.sum(r1 * r1, -1) < 5.991 * s2_1)
                & (torch.sum(r2 * r2, -1) < 5.991 * s2_2[idx2c])
                & (ratio_dist * ratio_factor > ratio_oct)
                & (ratio_dist < ratio_oct * ratio_factor))

        max_d = d1 * torch.pow(sf_t, oct1.to(torch.float32))
        min_d = max_d / (sf ** (cfg.extractor.n_levels - 1))
        normal = ray1 / torch.clamp(d1[:, None], min=1e-9) + ray2 / torch.clamp(d2[:, None],
                                                                               min=1e-9)
        normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)
        n_good = torch.sum(good.to(torch.int32), dtype=torch.int32)
        m, new_idx = ms.add_mappoints(
            m, n_new=n_good, pos=X, desc=kfs.desc[k], normal=normal, min_dist=min_d,
            max_dist=max_d, ref_kf=torch.full((N,), 0, dtype=torch.int32, device=dev) + k,
            mp_ids=next_mp_id + total + torch.cumsum(good.to(torch.int32), 0) - 1,
            client_id=cid, new_valid=good,
        )
        # forward links in both keyframes (feature slots are unique)
        kfs2 = m.kfs
        mp_row1 = torch.where(good, new_idx, kfs2.mp_idx[k])
        feat2 = torch.where(good, idx2c, N - 1)
        row2 = kfs2.mp_idx[nb]
        mp_row2 = ms._add_at(row2, (feat2,), torch.where(good, new_idx - row2[feat2], 0), good)
        mp_idx = ms._set_row(ms._set_row(kfs2.mp_idx, k, mp_row1), nb, mp_row2)
        m = m.replace(kfs=kfs2.replace(mp_idx=mp_idx))
        new_obs = torch.where(good, new_idx, NO_MP)
        m = ms.register_observations(m, k, new_obs)
        m = ms.register_observations(m, nb, new_obs)
        total = total + n_good

    m = ms.update_normal_and_depth(m, sf, cfg.extractor.n_levels)
    return m, total


def _frustum_ok(mps_pos, normal, min_dist, max_dist, R, t, cam):
    """(uv, dist3, ok) of landmark positions seen from pose (R, t)."""
    Xc = (R @ mps_pos.T).T + t
    uv = _project(cam, Xc, 1e-6)
    view = mps_pos - (-(R.T @ t))
    dist3 = torch.linalg.norm(view, dim=-1)
    cosv = torch.sum(view * normal, -1) / torch.clamp(dist3, min=1e-9)
    ok = ((Xc[:, 2] > 0) & cam.in_bounds(uv) & (dist3 >= 0.8 * min_dist)
          & (dist3 <= 1.2 * max_dist) & (cosv > 0.5))
    return uv, dist3, ok


def _window_fuse_match(m, target_kf, uv, desc, ok, dist3, max_dist, cfg, radius_base):
    """Windowed match of projected candidates into the target keyframe with
    the fuse gates (TH_LOW, no ratio test, predicted octave +-1)."""
    kfs = m.kfs
    sf = cfg.extractor.scale_factor
    pred_oct = matching.predict_octave(dist3, max_dist, sf, cfg.extractor.n_levels)
    radius = radius_base * torch.pow(torch.tensor(sf, dtype=torch.float32, device=uv.device),
                                     pred_oct.to(torch.float32))
    t_idx, dmin, okm = matching.match_in_window(
        uv, desc, ok, kfs.xy[target_kf], kfs.desc[target_kf], kfs.feat_valid[target_kf],
        radius=radius, th_dist=matching.TH_LOW, nn_ratio=1.0,
        t_octave=kfs.octave[target_kf], octave_min=pred_oct - 1, octave_max=pred_oct + 1,
    )
    return t_idx, matching._unique_target(t_idx, dmin, okm, kfs.n_feat)


def _fuse_links(m, target_kf, t_idx, okm, cand, cand_wins):
    """Shared tail of the fuse passes: a free target feature gets the
    candidate (case A); an occupied one merges the two landmarks (case B,
    the loser chosen by ``cand_wins``).  Returns (map with the forward links
    written, n_free, n_dup, loser, winner)."""
    kfs, mps = m.kfs, m.mps
    N, Mcap = kfs.n_feat, mps.capacity
    row = kfs.mp_idx[target_kf]
    existing = row[t_idx.clamp(0, N - 1).long()]
    free_hit = okm & (existing < 0)
    tsafe = torch.where(free_hit, t_idx, N - 1).long()
    row = ms._add_at(row, (tsafe,), torch.where(free_hit, cand - row[tsafe], 0), free_hit)
    m = m.replace(kfs=kfs.replace(mp_idx=ms._set_row(kfs.mp_idx, target_kf, row)))
    dup_hit = okm & (existing >= 0) & (existing != cand)
    ex_safe = existing.clamp(0, Mcap - 1)
    wins = cand_wins(ex_safe)
    loser = torch.where(dup_hit, torch.where(wins, ex_safe, cand), -1)
    winner = torch.where(dup_hit, torch.where(wins, cand, ex_safe), -1)
    return m, torch.sum(free_hit), torch.sum(dup_hit), loser, winner


def fuse_into(m: ms.MapState, target_kf, cand_mask, cam, cfg: SystemConfig,
              radius_base: float = 3.0, prefer_candidate: bool = False):
    """Project candidate landmarks (a mask over the arena) into target_kf and
    fuse (ORBmatcher::Fuse): free feature -> new association; occupied
    feature -> merge, keeping the landmark with more observations, or the
    candidate when ``prefer_candidate`` (the loop-closure rule)."""
    kfs, mps = m.kfs, m.mps
    tk = torch.as_tensor(target_kf, device=mps.pos.device).long()
    uv, dist3, ok = _frustum_ok(mps.pos, mps.normal, mps.min_dist, mps.max_dist,
                                kfs.R_cw[tk], kfs.t_cw[tk], cam)
    ok = ok & cand_mask & mps.valid & ~mps.bad
    t_idx, okm = _window_fuse_match(m, tk, uv, mps.desc, ok, dist3, mps.max_dist, cfg,
                                    radius_base)
    self_ids = torch.arange(mps.capacity, dtype=torch.int32, device=uv.device)
    if prefer_candidate:
        def wins(ex):
            return torch.ones_like(ex, dtype=torch.bool)
    else:
        def wins(ex):
            return mps.obs_n > mps.obs_n[ex.long()]
    m, n_add, n_dup, loser, winner = _fuse_links(m, tk, t_idx, okm, self_ids, wins)
    return ms.replace_mappoints(m, loser, winner), n_add, n_dup


def _fuse_subset(m, target_kf, cand_idx, cand_ok, cam, cfg, radius_base=3.0, rebuild=True):
    """fuse_into over a compact candidate index set [P] (the per-keyframe
    work scales with the candidates, not the arena); the reverse-table
    rebuild can be deferred by a caller batching several passes."""
    kfs, mps = m.kfs, m.mps
    tk = torch.as_tensor(target_kf, device=mps.pos.device).long()
    ci = cand_idx.clamp(0, mps.capacity - 1)
    cil = ci.long()
    uv, dist3, ok = _frustum_ok(mps.pos[cil], mps.normal[cil], mps.min_dist[cil],
                                mps.max_dist[cil], kfs.R_cw[tk], kfs.t_cw[tk], cam)
    ok = ok & cand_ok & mps.valid[cil] & ~mps.bad[cil]
    t_idx, okm = _window_fuse_match(m, tk, uv, mps.desc[cil], ok, dist3, mps.max_dist[cil],
                                    cfg, radius_base)
    m, n_add, n_dup, loser, winner = _fuse_links(
        m, tk, t_idx, okm, ci, lambda ex: mps.obs_n[cil] > mps.obs_n[ex.long()])
    m = ms.replace_mappoints(m, loser, winner, rebuild=rebuild)
    return m, n_add, n_dup, loser, winner


def fuse_neighbors(m: ms.MapState, kf_idx, cam, cfg: SystemConfig, n_neighbors: int = 10):
    """Duplicate-landmark fusion with the covisible neighbors
    (SearchInNeighbors + ORBmatcher::Fuse): the neighbors' landmarks into the
    target keyframe, then the target's landmarks into each neighbor.

    Returns (map', n_added, n_merged, redirect [M]): the loser -> winner
    table composed over the pass (CheckReplacedInLastFrame)."""
    sf = cfg.extractor.scale_factor
    N = m.kfs.n_feat
    Mcap = m.mps.capacity
    dev = m.mps.pos.device
    k = torch.as_tensor(kf_idx, device=dev).long()
    row = ms.covis_row(m, k)
    nbr_w, nbr_idx = top_k_stable(row, n_neighbors)

    cand_idx = m.kfs.mp_idx[nbr_idx].reshape(-1)
    cand_ok = (cand_idx >= 0) & torch.repeat_interleave(nbr_w > 0, N)
    # dedup within the set and exclude landmarks already in the target
    ci = cand_idx.clamp(0, Mcap - 1).long()
    rank1 = torch.arange(cand_idx.shape[0], dtype=torch.int32, device=dev) + 1
    first = torch.zeros(Mcap, dtype=torch.int32, device=dev).scatter_reduce(
        0, ci, torch.where(cand_ok, rank1, 0), "amax")
    cand_ok = cand_ok & (first[ci] == rank1)
    own = m.kfs.mp_idx[k]
    in_target = ms._bool_at(torch.zeros(Mcap, dtype=torch.bool, device=dev),
                            own.clamp(0, Mcap - 1), own >= 0, "amax")
    cand_ok = cand_ok & ~in_target[ci]

    ident = torch.arange(Mcap, dtype=torch.int32, device=dev)

    def compose(redirect, loser, winner):
        act = (loser >= 0) & (winner >= 0) & (loser != winner)
        safe_l = torch.where(act, loser, Mcap - 1).long()
        won = torch.full((Mcap,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, safe_l, torch.where(act, winner, -1).to(torch.int32), "amax")
        return torch.where(won >= 0, won, ident)[redirect.long()]

    m, n_add, n_merge, lo, wi = _fuse_subset(m, k, cand_idx, cand_ok, cam, cfg, rebuild=False)
    redirect = compose(ident, lo, wi)

    # reverse direction: the target's landmarks into each neighbor (already
    # linked candidates stay eligible: cross-duplicates merge)
    own2 = m.kfs.mp_idx[k]
    own_ok0 = own2 >= 0
    for i in range(n_neighbors):
        m, a, g, lo, wi = _fuse_subset(m, nbr_idx[i], own2, own_ok0 & (nbr_w[i] > 0), cam,
                                       cfg, rebuild=False)
        n_add = n_add + a
        n_merge = n_merge + g
        redirect = compose(redirect, lo, wi)

    m = ms.rebuild_observations(m)
    m = ms.update_normal_and_depth(m, sf, cfg.extractor.n_levels)
    m = ms.compute_distinctive_descriptors(m)
    return m, n_add, n_merge, redirect


def keyframe_redundancy(m: ms.MapState, cfg: SystemConfig):
    """Per-keyframe redundancy ratio (KeyFrameCullingV3, Mapping.cpp:771-863):
    the fraction of a keyframe's landmarks observed by >= 3 other keyframes at
    the same or a finer pyramid scale (+1 tolerance).  Counts are integers,
    the ratio fp32.  Returns ratio [K] (0 for dead keyframes)."""
    kfs, mps = m.kfs, m.mps
    K, N = kfs.capacity, kfs.n_feat
    dev = kfs.mp_idx.device
    mp = kfs.mp_idx
    has = (mp >= 0) & kfs.feat_valid
    mpc = mp.clamp(0, mps.capacity - 1).long()
    # octave of every observation of a landmark, through the reverse table
    obs_kf = mps.obs_kf.clamp(0, K - 1).long()
    obs_feat = mps.obs_feat.clamp(0, N - 1).long()
    obs_ok = ms._slot_valid(mps)
    obs_oct = kfs.octave[obs_kf, obs_feat]            # [M,O]
    p_oct, p_ok, p_kf = obs_oct[mpc], obs_ok[mpc], mps.obs_kf[mpc]  # [K,N,O]
    fine = (p_ok & (p_oct <= kfs.octave[..., None] + 1)
            & (p_kf != torch.arange(K, device=dev)[:, None, None]))
    redundant = has & (torch.sum(fine, dim=-1) >= 3)
    n_mps = torch.sum(has, dim=1)
    ratio = torch.sum(redundant, dim=1) / torch.clamp(n_mps, min=1)
    alive = kfs.valid & ~kfs.bad
    return torch.where(alive & (n_mps > 0), ratio.to(torch.float32), 0.0)


def cull_redundant_keyframes(m: ms.MapState, cfg: SystemConfig, protect_recent: int = 20):
    """Erase keyframes whose redundancy ratio reaches RedThres, except the
    newest ``protect_recent``, the two oldest (the gauge anchors) and the
    endpoints of loop edges.  Returns (map, n_culled).

    The loop-edge rule is the reference's (KeyFrame::AddLoopEdge sets
    mbNotErase, which SetBadFlag honours); the JAX package culls such
    keyframes (a declared divergence, ROADMAP section 3)."""
    ratio = keyframe_redundancy(m, cfg)
    kfs = m.kfs
    alive = kfs.valid & ~kfs.bad
    order = kfs.insert_order
    newest = torch.max(torch.where(alive, order, -1))
    recent = order > newest - protect_recent
    oldest = torch.sort(torch.where(alive, order, ms._I32_MAX)).values[:2]
    anchor = (order == oldest[0]) | (order == oldest[1])
    looped = torch.any(kfs.loop_edges >= 0, dim=1)
    kill = alive & ~recent & ~anchor & ~looped & (ratio >= cfg.mapping.red_thres)
    m = ms.compact_observations(ms.erase_keyframes(m, kill))
    return m, torch.sum(kill)


def local_ba(m: ms.MapState, kf_idx, cam, cfg: SystemConfig, iters: int = 15):
    """Windowed local BA (LocalBundleAdjustmentClient, Optimizer.cpp:349-644):
    the new keyframe + its covisible neighbors (weight >= 15) are free, the
    other observers of their landmarks enter as fixed anchors, only the
    local landmarks move; the subproblem is gathered into fixed
    (local_ba_max_cams, local_ba_max_points) shapes.  Observations failing
    the chi2 gate afterwards are detached.

    Returns (map', cost, n_good_obs, n_truncated)."""
    kfs, mps = m.kfs, m.mps
    K, M, N, O = kfs.capacity, mps.capacity, kfs.n_feat, mps.max_obs
    C = min(cfg.mapping.local_ba_max_cams, K)
    P = min(cfg.mapping.local_ba_max_points, M)
    dev = kfs.R_cw.device
    k = torch.as_tensor(kf_idx, device=dev).long()
    alive = kfs.valid & ~kfs.bad
    alive_mp = mps.valid & ~mps.bad

    # free set: the new KF + covisible neighbors at weight >= 15; the two
    # oldest alive keyframes stay fixed (the monocular gauge anchor)
    row = ms.covis_row(m, k)
    free = ms._set_row(row >= 15, k, True) & alive
    order = torch.where(alive, kfs.insert_order, ms._I32_MAX)
    oldest2 = torch.argsort(order, stable=True)[:2]
    free = free.index_put((oldest2,), torch.zeros(2, dtype=torch.bool, device=dev))

    # local landmarks: observed by any free camera
    slot_ok = ms._slot_valid(mps)
    okf = mps.obs_kf.clamp(0, K - 1).long()
    lm_local = torch.any(slot_ok & free[okf], dim=1) & alive_mp
    n_lm_local = torch.sum(lm_local.to(torch.int32))
    lm_sel = torch.argsort((~lm_local).to(torch.uint8), stable=True)[:P]
    lm_live = torch.arange(P, device=dev) < torch.clamp(n_lm_local, max=P)

    # cameras: free + anchors (observers of the selected landmarks)
    obs_sel_kf = okf[lm_sel]
    sel_ok = slot_ok[lm_sel] & lm_live[:, None]
    needed = ms._bool_at(torch.zeros(K, dtype=torch.bool, device=dev),
                         obs_sel_kf.reshape(-1), sel_ok.reshape(-1), "amax")
    cam_in = (needed | free) & alive
    prio = torch.where(free, 2_000_000 + row, torch.where(cam_in, 1_000_000 + row, -1))
    prio_top, cam_order = top_k_stable(prio, C)
    cam_live = prio_top >= 1_000_000
    cam_lut = torch.full((K,), -1, dtype=torch.int32, device=dev).index_put(
        (cam_order,), torch.where(cam_live, torch.arange(C, dtype=torch.int32, device=dev), -1))
    n_trunc = (torch.sum(cam_in.to(torch.int32)) - torch.sum(cam_live.to(torch.int32))
               + n_lm_local - torch.sum(lm_live.to(torch.int32)))

    # gather the subproblem
    ci = cam_lut[obs_sel_kf]
    obs_valid = sel_ok & (ci >= 0)
    feat = mps.obs_feat[lm_sel].clamp(0, N - 1).long()
    cam_fixed = ~free[cam_order] | ~cam_live
    point_valid = lm_live & (torch.sum(obs_valid, 1) >= 2)
    prob = ba.BAProblem(
        R=kfs.R_cw[cam_order].contiguous(), t=kfs.t_cw[cam_order].contiguous(),
        X=mps.pos[lm_sel].contiguous(), cam_idx=ci.clamp(0, C - 1).contiguous(),
        uv=kfs.xy[obs_sel_kf, feat].contiguous(),
        sigma2=level_sigma2(kfs.octave[obs_sel_kf, feat]).contiguous(),
        obs_valid=obs_valid.contiguous(), cam_fixed=cam_fixed.contiguous(),
        point_valid=point_valid.contiguous(), fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
    )
    R, t, X, cost, n_good = ba.ba_solve(prob, iters=iters)

    # scatter back: free camera poses + moved landmarks (delta discipline)
    move_cam = ~cam_fixed
    co = torch.where(move_cam, cam_order, K - 1)
    kfs2 = kfs.replace(
        R_cw=ms._add_at(kfs.R_cw, (co,), torch.where(move_cam[:, None, None],
                                                     R - kfs.R_cw[co], 0.0), move_cam),
        t_cw=ms._add_at(kfs.t_cw, (co,), torch.where(move_cam[:, None], t - kfs.t_cw[co], 0.0),
                        move_cam),
        pose_version=ms._add_at(kfs.pose_version, (co,), move_cam.to(torch.int32), move_cam),
    )
    po = torch.where(point_valid, lm_sel, M - 1)
    mps2 = mps.replace(
        pos=ms._add_at(mps.pos, (po,), torch.where(point_valid[:, None], X - mps.pos[po], 0.0),
                       point_valid),
        pos_version=ms._add_at(mps.pos_version, (po,), point_valid.to(torch.int32), point_valid),
    )
    m = m.replace(kfs=kfs2, mps=mps2)

    # outlier observation removal on the subproblem
    good_obs = ba.classify_outliers(prob, R, t, X)
    cur = m.kfs.mp_idx[obs_sel_kf, feat]
    rm = prob.obs_valid & ~good_obs & (cur == lm_sel[:, None])
    mp_idx2 = ms._add_at(m.kfs.mp_idx, (obs_sel_kf, feat), torch.where(rm, NO_MP - cur, 0), rm)
    m = ms.rebuild_observations(m.replace(kfs=m.kfs.replace(mp_idx=mp_idx2)))
    return m, cost, n_good, n_trunc
