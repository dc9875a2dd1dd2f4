"""Client visual-odometry front-end: the per-frame tracking stages (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/tracking.py`` (the reference's
``Tracking``, cslam/src/Tracking.cpp:95-743): each stage is a function over
(MapState, Frame) on one device; ``tracker.Tracker`` drives the per-frame
state machine and reads only scalar counters on the host.

  MonocularInitialization (:290)      -> initialize_map()
  TrackWithMotionModel (:567)         -> track_with_motion_model()
  TrackReferenceKeyFrame (:514)       -> track_reference_kf()
  TrackLocalMap (:621) + SearchLocalPoints (:745) -> track_local_map()
  CreateNewKeyFrame (:710)            -> create_keyframe()

Framework divergences handled here: ``nanmedian`` averages the two middle
values as ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower);
``argmax`` picks the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

import torch

from ..config import SystemConfig
from ..models import map_store as ms
from ..ops import initializer as init_ops
from ..ops import matching
from ..solvers import ba, pose_opt
from ..solvers.reproj import level_sigma2
from ..utils.lie import SE3, orthonormalize
from .frame import Frame

NO_MP = ms.NO_MP


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def match_for_initialization(f_ref: Frame, f_cur: Frame, cfg: SystemConfig):
    idx, _, ok = matching.search_for_initialization(
        f_ref.xy, f_ref.desc, f_ref.valid, f_ref.angle, f_ref.octave,
        f_cur.xy, f_cur.desc, f_cur.valid, f_cur.angle, f_cur.octave,
    )
    return idx, ok, torch.sum(ok)


def initialize_map(f_ref: Frame, f_cur: Frame, match_idx, match_ok, cam, cfg: SystemConfig,
                   client_id=0, idx_f=None, idx_h=None, generator=None):
    """Two-view bootstrap + initial map + full BA (20 iterations) +
    median-depth normalization (MonocularInitialization +
    CreateInitialMapMonocular).  ``idx_f``/``idx_h``: the two-view RANSAC
    samples (drawn from ``generator`` when absent).

    Returns (map_state, f_ref', f_cur', success, n_good)."""
    cap = cfg.capacity
    N = f_ref.n_feat
    dev = f_ref.xy.device
    cur_feat = match_idx.long().clamp(0, N - 1)
    out = init_ops.initialize_two_view(f_ref.xy, f_cur.xy[cur_feat], match_ok, cam.K,
                                       sigma=1.0, idx_f=idx_f, idx_h=idx_h,
                                       generator=generator)
    good = out["good"] & out["success"]
    X = out["X"]

    # median depth scaling (ComputeSceneMedianDepth: median z == 1)
    med = ms.nanmedian(torch.where(good, X[:, 2], float("nan")))
    med = torch.where(torch.isfinite(med) & (med > 1e-6), med, 1.0)
    scale = 1.0 / med
    X = X * scale
    t_kf1 = out["t"] * scale

    m = ms.empty_map(cap.client_max_kfs, cap.client_max_mps, N, cap.max_obs_per_mp, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cid = torch.full((N,), int(client_id), dtype=torch.int32, device=dev)
    m, mp_idx = ms.add_mappoints(
        m, n_new=torch.sum(good), pos=X, desc=f_cur.desc[cur_feat],
        normal=torch.tensor([0.0, 0.0, 1.0], **f32).repeat(N, 1),
        min_dist=torch.zeros(N, **f32), max_dist=torch.full((N,), float("inf"), **f32),
        ref_kf=torch.ones(N, dtype=torch.int32, device=dev),
        mp_ids=torch.arange(N, dtype=torch.int32, device=dev), client_id=cid,
        new_valid=good,
    )
    m, _ = ms.add_keyframe(
        m, 0, int(client_id), f_ref.timestamp, torch.eye(3, **f32), torch.zeros(3, **f32),
        f_ref.xy, f_ref.desc, f_ref.octave, f_ref.angle, f_ref.valid, mp_assoc=mp_idx)
    assoc1 = torch.full((N,), NO_MP, dtype=torch.int32, device=dev)
    tgt = torch.where(good, cur_feat, N - 1)
    assoc1 = ms._add_at(assoc1, (tgt,), torch.where(good, mp_idx - assoc1[tgt], 0), good)
    m, k1 = ms.add_keyframe(
        m, 1, int(client_id), f_cur.timestamp, out["R"], t_kf1,
        f_cur.xy, f_cur.desc, f_cur.octave, f_cur.angle, f_cur.valid, mp_assoc=assoc1)
    m = ms.update_normal_and_depth(m, cfg.extractor.scale_factor, cfg.extractor.n_levels)

    # full BA on the 2-view problem (GlobalBundleAdjustemntClient, 20 iters)
    fixed = torch.arange(cap.client_max_kfs, device=dev) == 0
    prob = build_ba_problem(m, cam, fixed_mask=fixed)
    R_b, t_b, X_b, _, _ = ba.ba_solve(prob, iters=20)
    m = apply_ba_result(m, R_b, t_b, X_b, torch.ones(cap.client_max_kfs, dtype=torch.bool,
                                                     device=dev))

    # post-BA depth/parallax hygiene (quasi-unobservable depths pushed far away)
    mps = m.mps
    alive = mps.valid & ~mps.bad
    k1l = k1.long()
    O1 = -(m.kfs.R_cw[k1l].T @ m.kfs.t_cw[k1l])
    ray0 = mps.pos
    ray1 = mps.pos - O1
    cosp = torch.sum(ray0 * ray1, -1) / torch.clamp(
        torch.linalg.norm(ray0, dim=-1) * torch.linalg.norm(ray1, dim=-1), min=1e-12)
    z0 = mps.pos[:, 2]
    medz = ms.nanmedian(torch.where(alive, z0, float("nan")))
    medz = torch.where(torch.isfinite(medz) & (medz > 0), medz, 1.0)
    junk = alive & ((cosp > 0.99997) | (z0 > 8.0 * medz) | (z0 <= 0))
    m = ms.erase_mappoints(m, junk)
    n_new = torch.sum(alive & ~junk)

    # masked-out rows of mp_idx / assoc1 carry the sentinel slot capacity-1;
    # the (idx >= 0) guard keeps a junk flag there out of real associations
    Mc = cap.client_max_mps
    mp_idx2 = torch.where(junk[mp_idx.clamp(0, Mc - 1).long()] & (mp_idx >= 0), NO_MP, mp_idx)
    assoc1b = torch.where(junk[assoc1.clamp(0, Mc - 1).long()] & (assoc1 >= 0), NO_MP, assoc1)
    f_ref2 = f_ref.replace(R_cw=torch.eye(3, **f32), t_cw=torch.zeros(3, **f32), mp=mp_idx2)
    f_cur2 = f_cur.replace(R_cw=m.kfs.R_cw[k1l], t_cw=m.kfs.t_cw[k1l], mp=assoc1b)
    return m, f_ref2, f_cur2, out["success"], n_new


def build_ba_problem(m: ms.MapState, cam, fixed_mask, extra_point_mask=None) -> ba.BAProblem:
    """Whole-arena BA problem: every valid KF is a camera (fixed per mask),
    every valid landmark with >= 2 observations a point; observations come
    from the reverse-obs tables."""
    kfs, mps = m.kfs, m.mps
    slot_ok = ms._slot_valid(mps)
    kf = mps.obs_kf.clamp(0, kfs.capacity - 1)
    feat = mps.obs_feat.clamp(0, kfs.n_feat - 1)
    uv = kfs.xy[kf.long(), feat.long()]
    sigma2 = level_sigma2(kfs.octave[kf.long(), feat.long()])
    kf_alive = kfs.valid & ~kfs.bad
    obs_valid = slot_ok & kf_alive[kf.long()]
    point_valid = mps.valid & ~mps.bad & (torch.sum(obs_valid, 1) >= 2)
    if extra_point_mask is not None:
        point_valid = point_valid & extra_point_mask
    return ba.BAProblem(
        R=kfs.R_cw.contiguous(), t=kfs.t_cw.contiguous(), X=mps.pos.contiguous(),
        cam_idx=kf.to(torch.int32).contiguous(), uv=uv.contiguous(),
        sigma2=sigma2.contiguous(), obs_valid=obs_valid.contiguous(),
        cam_fixed=(fixed_mask | ~kf_alive).contiguous(),
        point_valid=point_valid.contiguous(),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
    )


def apply_ba_result(m: ms.MapState, R, t, X, moved_kf_mask) -> ms.MapState:
    kfs = m.kfs.replace(
        R_cw=torch.where(moved_kf_mask[:, None, None], R, m.kfs.R_cw),
        t_cw=torch.where(moved_kf_mask[:, None], t, m.kfs.t_cw),
        pose_version=m.kfs.pose_version + moved_kf_mask.to(torch.int32),
    )
    mps = m.mps.replace(pos=X, pos_version=m.mps.pos_version + 1)
    return m.replace(kfs=kfs, mps=mps)


# ---------------------------------------------------------------------------
# Per-frame tracking stages
# ---------------------------------------------------------------------------


def _project(cam, Xc, eps):
    return torch.stack([cam.fx * Xc[:, 0] / torch.clamp(Xc[:, 2], min=eps) + cam.cx,
                        cam.fy * Xc[:, 1] / torch.clamp(Xc[:, 2], min=eps) + cam.cy], -1)


def _scatter_assoc(assoc, okm, t_idx, src, n_feat):
    """assoc.at[t_idx].add(where(okm, src - assoc[t_idx], 0)) with masked
    lanes routed to the last slot (the reference's delta discipline)."""
    tsafe = torch.where(okm, t_idx, n_feat - 1).long()
    return ms._add_at(assoc, (tsafe,), torch.where(okm, src - assoc[tsafe], 0), okm)


def track_with_motion_model(m: ms.MapState, frame: Frame, last: Frame, vel_R, vel_t, cam,
                            cfg: SystemConfig, window_factor: float = 1.0):
    """Project the last frame's landmarks with the constant-velocity
    prediction; windowed matching + pose-only BA (TrackWithMotionModel)."""
    R_pred = vel_R @ last.R_cw
    t_pred = (vel_R @ last.t_cw) + vel_t
    has_mp = last.mp >= 0
    mp = last.mp.clamp(0, m.mps.capacity - 1)
    mpl = mp.long()
    alive = has_mp & m.mps.valid[mpl] & ~m.mps.bad[mpl]
    Xc = (R_pred @ m.mps.pos[mpl].T).T + t_pred
    uv_pred = _project(cam, Xc, 1e-6)
    q_valid = alive & (Xc[:, 2] > 0)
    sf = torch.tensor(cfg.extractor.scale_factor, dtype=torch.float32, device=Xc.device)
    radius = 15.0 * window_factor * torch.pow(sf, last.octave.to(torch.float32))
    t_idx, dist, okm = matching.match_in_window(
        uv_pred, last.desc, q_valid, frame.xy, frame.desc, frame.valid,
        radius=radius, th_dist=matching.TH_HIGH, nn_ratio=0.9,
        t_octave=frame.octave, octave_min=last.octave - 1, octave_max=last.octave + 1,
    )
    okm = matching._unique_target(t_idx, dist, okm, frame.n_feat)
    assoc = torch.full((frame.n_feat,), NO_MP, dtype=torch.int32, device=Xc.device)
    assoc = _scatter_assoc(assoc, okm, t_idx, mp, frame.n_feat)
    frame2, n_inliers = _pose_opt_on_assoc(m, frame, assoc, R_pred, t_pred, cam, cfg)
    return frame2, torch.sum(okm), n_inliers


def track_reference_kf(m: ms.MapState, frame: Frame, ref_kf, cam, cfg: SystemConfig):
    """Brute descriptor matching (``match_brute``: the ``hamming_top2``
    kernel) against the reference keyframe's landmark features + pose-only
    BA from the frame's pose (TrackReferenceKeyFrame)."""
    kfs = m.kfs
    r = int(ref_kf)
    ref_mp = kfs.mp_idx[r]
    mp = ref_mp.clamp(0, m.mps.capacity - 1)
    mpl = mp.long()
    ref_ok = (ref_mp >= 0) & m.mps.valid[mpl] & ~m.mps.bad[mpl] & kfs.feat_valid[r]
    q_idx, _, okm = matching.match_brute(
        frame.desc, frame.valid, kfs.desc[r].contiguous(), ref_ok.contiguous(),
        th_dist=matching.TH_LOW, nn_ratio=0.7, q_angle=frame.angle, t_angle=kfs.angle[r],
    )
    assoc = torch.where(okm, mp[q_idx.clamp(0, frame.n_feat - 1)], NO_MP)
    frame2, n_inliers = _pose_opt_on_assoc(m, frame, assoc, frame.R_cw, frame.t_cw, cam, cfg)
    return frame2, torch.sum(okm), n_inliers


def _pose_opt_on_assoc(m, frame, assoc, R0, t0, cam, cfg):
    has = assoc >= 0
    X = m.mps.pos[assoc.clamp(0, m.mps.capacity - 1).long()]
    R, t, inlier, n_in = pose_opt.optimize_pose(
        R0, t0, X, frame.xy, has, frame.sigma2, cam.fx, cam.fy, cam.cx, cam.cy,
        rounds=cfg.opt.pose_opt_rounds, iters_per_round=cfg.opt.pose_opt_its_per_round,
    )
    return frame.replace(R_cw=R, t_cw=t, mp=torch.where(inlier, assoc, NO_MP)), n_in


def track_local_map(m: ms.MapState, frame: Frame, cam, cfg: SystemConfig,
                    window_factor: float = 1.0):
    """Match ALL alive landmarks into the frame (the local map is the whole
    client map) through frustum and viewing-angle gates, then a final
    pose-only BA (TrackLocalMap + SearchLocalPoints).

    Returns (map', frame', n_inliers, best_kf): the map with updated
    visible/found counters and the keyframe sharing most tracked landmarks."""
    mps = m.mps
    dev = mps.pos.device
    Mc = mps.capacity
    alive = mps.valid & ~mps.bad
    Xc = (frame.R_cw @ mps.pos.T).T + frame.t_cw
    z = Xc[:, 2]
    uv = _project(cam, Xc, 1e-6)
    Ow = -(frame.R_cw.T @ frame.t_cw)
    view = mps.pos - Ow
    dist = torch.linalg.norm(view, dim=-1)
    cos_view = torch.sum(view * mps.normal, -1) / torch.clamp(dist, min=1e-9)
    in_frustum = (alive & (z > 0) & cam.in_bounds(uv) & (dist >= 0.8 * mps.min_dist)
                  & (dist <= 1.2 * mps.max_dist) & (cos_view > 0.5))
    has = frame.mp >= 0
    already = ms._bool_at(torch.zeros(Mc, dtype=torch.bool, device=dev),
                          frame.mp.clamp(0, Mc - 1), has, "amax")

    sf = cfg.extractor.scale_factor
    pred_oct = matching.predict_octave(dist, mps.max_dist, sf, cfg.extractor.n_levels)
    r_base = torch.where(cos_view > 0.998, 2.5, 4.0)
    radius = r_base * window_factor * torch.pow(
        torch.tensor(sf, dtype=torch.float32, device=dev), pred_oct.to(torch.float32))
    free_feat = frame.valid & (frame.mp < 0)
    t_idx, dmin, okm = matching.match_in_window(
        uv, mps.desc, in_frustum & ~already, frame.xy, frame.desc, free_feat,
        radius=radius, th_dist=matching.TH_HIGH, nn_ratio=0.8,
        t_octave=frame.octave, octave_min=pred_oct - 1, octave_max=pred_oct + 1,
    )
    okm = matching._unique_target(t_idx, dmin, okm, frame.n_feat)
    assoc = _scatter_assoc(frame.mp, okm, t_idx,
                           torch.arange(Mc, dtype=torch.int32, device=dev), frame.n_feat)
    frame2, n_in = _pose_opt_on_assoc(m, frame, assoc, frame.R_cw, frame.t_cw, cam, cfg)

    # visibility / found statistics (MapPoint::IncreaseVisible/Found)
    n_visible = mps.n_visible + in_frustum.to(torch.int32)
    fmp = frame2.mp.clamp(0, Mc - 1).long()
    found = torch.zeros(Mc, dtype=torch.int32, device=dev).index_add(
        0, fmp, (frame2.mp >= 0).to(torch.int32))
    m2 = m.replace(mps=mps.replace(n_visible=n_visible, n_found=mps.n_found + found))

    # reference-KF re-selection (UpdateLocalKeyFrames, Tracking.cpp:956):
    # tracked landmarks vote for their observing keyframes; first max wins
    obs_kf = mps.obs_kf[fmp]
    obs_live = ((torch.arange(mps.max_obs, device=dev)[None, :] < mps.obs_n[fmp][:, None])
                & (frame2.mp >= 0)[:, None] & (obs_kf >= 0))
    K = m.kfs.capacity
    votes = torch.zeros(K, dtype=torch.int32, device=dev).index_add(
        0, obs_kf.clamp(0, K - 1).reshape(-1).long(), obs_live.reshape(-1).to(torch.int32))
    votes = torch.where(m.kfs.valid & ~m.kfs.bad, votes, -1)
    best_kf = torch.argmax(votes)
    return m2, frame2, n_in, best_kf


def create_keyframe(m: ms.MapState, frame: Frame, kf_id, client_id, cfg: SystemConfig):
    return ms.add_keyframe(
        m, kf_id, client_id, frame.timestamp, frame.R_cw, frame.t_cw,
        frame.xy, frame.desc, frame.octave, frame.angle, frame.valid, mp_assoc=frame.mp,
    )


def motion_velocity(frame: Frame, last: Frame):
    """T_vel = T_cur * T_last^-1 (constant-velocity model), re-orthonormalized
    (without it the pred -> track -> velocity loop amplifies float32
    defects)."""
    V = SE3(R=frame.R_cw, t=frame.t_cw).compose(SE3(R=last.R_cw, t=last.t_cw).inverse())
    return orthonormalize(V.R), V.t
