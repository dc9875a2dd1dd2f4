"""Host-side per-agent front-end loop: the state machine that strings the
tracking and mapping stages into a visual-odometry pipeline (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/tracker.py`` (``Tracking::Track``,
cslam/src/Tracking.cpp:126-287, plus the client ``LocalMapping`` step run per
new keyframe).  Array state stays on the tracker's device; the control flow
reads scalar counters on the host, as the reference does.  Each such read is
counted in ``stats["host_reads"]`` (a device sync on the card).

Tracking-loss policy as the reference: reset if lost before ``init_kfs``
keyframes after initialization, else LOST.  ``enable_relocalization`` arms
the staged PnP recovery (inline rescue, then the reference keyframe's
covisibility neighborhood, then the whole map).  ``enable_trimming`` bounds
the client map to the newest ``local_map_size`` keyframes
(``mapping.trim_keyframes``, Map::MapTrimming), erasing only those that
``trim_mask_fn`` calls trimmable (sent and acked).

Randomness: RANSAC samples come from ``rng``, a ``torch.Generator`` on the
device seeded ``42 + client_id`` (the reference seeds ``PRNGKey(42 +
client_id)``); the draws differ from JAX's, so end-to-end runs are held to
the reference's gates, not to its trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..models import map_store as ms
from ..ops import matching, orb, pnp
from ..utils.camera import Camera
from . import mapping, tracking
from .frame import Frame, build_frame

NOT_INITIALIZED = 0
OK = 1
LOST = 2


@dataclass
class TrajectoryEntry:
    timestamp: float
    R_cw: torch.Tensor
    t_cw: torch.Tensor


@dataclass
class Tracker:
    cfg: SystemConfig
    cam: Camera
    client_id: int = 0
    device: Optional[object] = None      # the card unless told otherwise
    state: int = NOT_INITIALIZED
    map: Optional[ms.MapState] = None
    ref_frame: Optional[Frame] = None    # init reference
    last_frame: Optional[Frame] = None
    vel_R: object = None
    vel_t: object = None
    has_velocity: bool = False
    ref_kf: int = 0
    next_kf_id: int = 0
    frames_since_kf: int = 0
    kfs_since_init: int = 0
    n_lost_frames: int = 0
    prev_inliers: int = 0
    trajectory: list = field(default_factory=list)
    kf_events: list = field(default_factory=list)  # new-KF arena idx stream
    rng: Optional[torch.Generator] = None
    enable_mapping: bool = True
    enable_trimming: bool = False  # standalone evaluation keeps the full map
    # CanBeForgotten gate of trimming (Map::MapTrimming erases only sent and
    # acked entities): a callable map -> [K] bool, e.g.
    # communicator.trimmable_mask over the live comm state
    trim_mask_fn: object = None
    enable_relocalization: bool = False
    reset_epoch: int = 0
    last_compaction: object = None  # (kf_remap, mp_remap) of the latest compact
    stats: dict = field(default_factory=lambda: {
        "kf_created": 0, "mp_created": 0, "host_reads": 0, "init_calls": 0,
        "local_ba_calls": 0, "local_ba_iters": 0, "ref_kf_tracks": 0, "brute_matches": 0})

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.rng is None:
            self.rng = torch.Generator(device=self.device).manual_seed(42 + self.client_id)

    # -- host reads (each one a device sync on the card) ----------------------

    def _int(self, x) -> int:
        self.stats["host_reads"] += 1
        return int(x)

    def _bool(self, x) -> bool:
        self.stats["host_reads"] += 1
        return bool(x)

    # -- public API ---------------------------------------------------------

    def process_image(self, img, timestamp: float):
        ex = self.cfg.extractor
        nf = ex.n_features * (ex.init_features_factor if self.state == NOT_INITIALIZED else 1)
        nf = min(nf, self.cfg.capacity.max_keypoints)
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        feats = orb.extract(
            img, n_features=nf, n_levels=ex.n_levels, scale_factor=ex.scale_factor,
            ini_th=float(ex.ini_th_fast), min_th=float(ex.min_th_fast), cell=ex.cell_size,
            capacity=self.cfg.capacity.max_keypoints,
        )
        return self.process_frame(build_frame(feats, self.cam, timestamp, ex.scale_factor))

    def process_frame(self, frame: Frame):
        """Returns the tracked Frame (pose populated) or None."""
        if self.state == NOT_INITIALIZED:
            return self._initialize(frame)
        if self.state == LOST:
            if self.enable_relocalization and self.map is not None:
                out = self._relocalize(frame)
                if out is not None:
                    return out
            self.trajectory.append(None)
            return None
        return self._track(frame)

    # -- relocalization -------------------------------------------------------

    def _neighborhood_lm_mask(self, ref_kf: int):
        """Landmarks observed by ref_kf's covisibility neighborhood: the
        candidate set for recovery near the loss point."""
        m = self.map
        Mc = m.mps.capacity
        mp = m.kfs.mp_idx
        nbhd = ms._set_row(ms.covis_row(m, ref_kf) > 0, torch.tensor(ref_kf, device=mp.device),
                           True)
        has = (mp >= 0) & nbhd[:, None]
        mask = ms._bool_at(torch.zeros(Mc, dtype=torch.bool, device=mp.device),
                           mp.clamp(0, Mc - 1).reshape(-1), has.reshape(-1), "amax")
        return mask & m.mps.valid & ~m.mps.bad

    def _pnp_recover(self, frame: Frame, cand_mask, tag: str):
        """Brute-match a candidate landmark set, RANSAC-PnP the absolute
        pose, refine, gate on local-map inliers.  The recovered Frame or None."""
        m = self.map
        t_idx, _, okm = matching.match_brute(
            frame.desc, frame.valid, m.mps.desc, cand_mask.contiguous(),
            th_dist=matching.TH_LOW, nn_ratio=0.75, check_rotation=False)
        self.stats["brute_matches"] += 1
        self.stats[f"reloc_{tag}_match"] = self._int(torch.sum(okm))
        if self.stats[f"reloc_{tag}_match"] < 15:
            self.stats["reloc_fail"] = f"{tag}:brute"
            return None
        mp = t_idx.clamp(0, m.mps.capacity - 1)
        res = pnp.ransac_pnp(m.mps.pos[mp], frame.xy, okm, frame.sigma2, self.cam.fx,
                             self.cam.fy, self.cam.cx, self.cam.cy, generator=self.rng)
        self.stats[f"reloc_{tag}_pnp"] = self._int(res["n_inliers"])
        if not self._bool(res["success"]) or self.stats[f"reloc_{tag}_pnp"] < 15:
            self.stats["reloc_fail"] = f"{tag}:pnp"
            return None
        assoc = torch.where(okm & res["inliers"], mp.to(torch.int32), ms.NO_MP)
        frame2, _ = tracking._pose_opt_on_assoc(m, frame, assoc, res["R"], res["t"],
                                                self.cam, self.cfg)
        m2, frame3, n_in2, best_kf = tracking.track_local_map(m, frame2, self.cam, self.cfg,
                                                              window_factor=2.0)
        self.stats[f"reloc_{tag}_lm"] = self._int(n_in2)
        if self.stats[f"reloc_{tag}_lm"] < self.cfg.tracking.local_map_inlier_thres:
            self.stats["reloc_fail"] = f"{tag}:localmap"
            return None
        self.map = m2
        self.ref_kf = self._int(best_kf)
        self.stats["reloc_fail"] = f"{tag}:ok"
        return frame3

    def _relocalize(self, frame: Frame):
        """Opt-in relocalization after tracking loss, staged: the last
        reference keyframe's covisibility neighborhood first, then the
        whole map (the reference ships this only as dead code)."""
        frame3 = self._pnp_recover(frame, self._neighborhood_lm_mask(self.ref_kf), "local")
        if frame3 is None:
            frame3 = self._pnp_recover(frame, self.map.mps.valid & ~self.map.mps.bad, "global")
        if frame3 is None:
            return None
        self.state = OK
        self.last_frame = frame3
        self.has_velocity = False
        self.frames_since_kf = 0
        self.trajectory.append(TrajectoryEntry(float(frame3.timestamp), frame3.R_cw,
                                               frame3.t_cw))
        return frame3

    # -- initialization -----------------------------------------------------

    def _initialize(self, frame: Frame):
        n = self._int(frame.n)
        if self.ref_frame is None or n < 100:
            self.ref_frame = frame if n >= 100 else None
            self.trajectory.append(None)
            return None
        idx, ok, n_match = tracking.match_for_initialization(self.ref_frame, frame, self.cfg)
        if self._int(n_match) < 100:
            self.ref_frame = frame  # too few matches: restart from here
            self.trajectory.append(None)
            return None
        self.stats["init_calls"] += 1
        m, _, f_cur, success, n_good = tracking.initialize_map(
            self.ref_frame, frame, idx, ok, self.cam, self.cfg, client_id=self.client_id,
            generator=self.rng)
        n_good = self._int(n_good)
        if not self._bool(success) or n_good < 80:
            self.trajectory.append(None)
            return None
        self.map = m
        self.state = OK
        self.last_frame = f_cur
        self.ref_kf = 1
        self.next_kf_id = 2
        self.frames_since_kf = 0
        self.kfs_since_init = 0
        self.has_velocity = False
        self.stats["kf_created"] += 2
        self.stats["mp_created"] += n_good
        self.kf_events.extend([0, 1])
        self.trajectory.append(TrajectoryEntry(float(frame.timestamp), f_cur.R_cw, f_cur.t_cw))
        return f_cur

    # -- per-frame tracking -------------------------------------------------

    def _track(self, frame: Frame):
        cfg = self.cfg
        t = cfg.tracking
        n_inliers = 0
        tracked = None

        self.stats["path"] = "none"
        if self.has_velocity:
            f2, n_match, n_in = tracking.track_with_motion_model(
                self.map, frame, self.last_frame, self.vel_R, self.vel_t, self.cam, cfg)
            self.stats["path"] = "mm"
            n_match = self._int(n_match)
            if n_match < t.motion_model_inlier_thres_search:
                # widen the window once (the reference retries with th*2)
                f2, n_match, n_in = tracking.track_with_motion_model(
                    self.map, frame, self.last_frame, self.vel_R, self.vel_t, self.cam, cfg,
                    window_factor=t.mm_retry_window)
                self.stats["path"] = "mm2"
                n_match = self._int(n_match)
            n_in = self._int(n_in)
            # BOTH gates must pass, else fall back to the reference keyframe
            if n_match >= t.motion_model_inlier_thres_search and \
                    n_in >= t.motion_model_inlier_thres_opt:
                tracked = f2
                n_inliers = n_in
            self.stats["mm_n_match"] = n_match
            self.stats["mm_n_in"] = n_in

        if tracked is None:
            frame_init = frame.replace(R_cw=self.last_frame.R_cw, t_cw=self.last_frame.t_cw)
            f2, n_match, n_in = tracking.track_reference_kf(self.map, frame_init, self.ref_kf,
                                                            self.cam, cfg)
            self.stats["ref_kf_tracks"] += 1
            self.stats["brute_matches"] += 1
            self.stats["path"] = self.stats["path"] + "+ref"
            n_match, n_in = self._int(n_match), self._int(n_in)
            self.stats["ref_n_match"] = n_match
            self.stats["ref_n_in"] = n_in
            if n_match >= t.ref_kf_inlier_thres_search and n_in >= t.ref_kf_inlier_thres_opt:
                tracked = f2
                n_inliers = n_in

        if tracked is None and self.enable_relocalization:
            # on-the-spot PnP rescue before declaring loss
            rec = self._pnp_recover(frame, self._neighborhood_lm_mask(self.ref_kf), "inline")
            if rec is not None:
                self.stats["path"] = self.stats["path"] + "+pnp"
                tracked = rec
                n_inliers = self.stats.get("reloc_inline_lm", 0)
                self.has_velocity = False

        if tracked is None:
            return self._handle_lost(frame)

        # local-map refinement; near-loss rescue with a widened window only
        self.map, f3, n_in3, best_kf = tracking.track_local_map(self.map, tracked, self.cam, cfg)
        n_in3 = self._int(n_in3)
        self.stats["lm_n_in_a"] = n_in3
        if n_in3 < t.local_map_inlier_thres:
            self.map, f3b, n_in3b, best_kf_b = tracking.track_local_map(
                self.map, f3, self.cam, cfg, window_factor=3.0)
            self.stats["path"] = self.stats["path"] + "+wide"
            n_in3b = self._int(n_in3b)
            if n_in3b > n_in3:
                f3, n_in3, best_kf = f3b, n_in3b, best_kf_b
        self.ref_kf = self._int(best_kf)  # mpReferenceKF re-selection
        if n_in3 < t.matches_inliers_thres:
            return self._handle_lost(frame)
        tracked = f3
        n_inliers = n_in3
        self.prev_inliers = n_inliers

        self.vel_R, self.vel_t = tracking.motion_velocity(tracked, self.last_frame)
        self.has_velocity = True
        self.last_frame = tracked
        self.frames_since_kf += 1
        self.trajectory.append(TrajectoryEntry(float(tracked.timestamp), tracked.R_cw,
                                               tracked.t_cw))

        # keyframe decision (NeedNewKeyFrame, Tracking.cpp:662-708): mapping
        # runs synchronously, so the decision reduces to c1 && c2
        min_obs = 2 if self.kfs_since_init + 2 <= 2 else 3
        mps = self.map.mps
        ref_assoc = self.map.kfs.mp_idx[self.ref_kf]
        ref_mp = ref_assoc.clamp(0, mps.capacity - 1).long()
        ref_n = self._int(torch.sum((ref_assoc >= 0) & mps.valid[ref_mp] & ~mps.bad[ref_mp]
                                    & (mps.obs_n[ref_mp] >= min_obs)))
        c1 = self.frames_since_kf >= t.min_frames
        c2 = n_inliers < ref_n * t.th_ref_ratio and n_inliers > t.matches_inliers_thres
        self.stats["last_ref_n"] = ref_n
        self.stats["last_inliers"] = n_inliers
        if c1 and c2 and self._int(self.map.next_kf) < self.cfg.capacity.client_max_kfs - 1:
            self._create_keyframe(tracked)
        return tracked

    def _create_keyframe(self, frame: Frame):
        cfg = self.cfg
        self.map, k = tracking.create_keyframe(self.map, frame, self.next_kf_id, self.client_id,
                                               cfg)
        k = self._int(k)
        self.ref_kf = k
        self.next_kf_id += 1
        self.frames_since_kf = 0
        self.kfs_since_init += 1
        self.stats["kf_created"] += 1
        self.kf_events.append(k)

        if self.enable_mapping:
            self.map, _ = mapping.cull_mappoints(self.map, self.next_kf_id - 1, cfg)
            self.map, n_new = mapping.triangulate_new_points(self.map, k, self.cam, cfg,
                                                             client_id=self.client_id)
            self.stats["mp_created"] += self._int(n_new)
            self.map, _, _, redir = mapping.fuse_neighbors(self.map, k, self.cam, cfg)
            self._check_replaced(redir)
            if self.enable_trimming:
                trimmable = None if self.trim_mask_fn is None else self.trim_mask_fn(self.map)
                self.map, n_trim, n_held = mapping.trim_keyframes(self.map, cfg, trimmable)
                self.stats["kf_trimmed"] = self.stats.get("kf_trimmed", 0) + self._int(n_trim)
                n_held = self._int(n_held)
                if n_held > 0:  # comm backpressure: over-window keyframes not
                    self.stats["trim_held"] = n_held  # yet sent and acked
            self.map, _, _, n_trunc = self._local_ba(k, 15)
            if cfg.mapping.second_fuse_pass:
                # re-fuse on the refined geometry, then a short BA
                self.map, n_re, _, redir = mapping.fuse_neighbors(self.map, k, self.cam, cfg)
                self._check_replaced(redir)
                if self._int(n_re) > 0:
                    self.map, _, _, n_trunc = self._local_ba(k, 8)
            n_trunc = self._int(n_trunc)
            if n_trunc > 0:
                # no silent caps: the local-BA window dropped anchors/points
                self.stats["local_ba_truncated"] = (
                    self.stats.get("local_ba_truncated", 0) + n_trunc)
                print(f"[tracker] local_ba window truncated {n_trunc} entities "
                      f"(raise mapping.local_ba_max_cams/points)")

        # arena pressure: compact when the cursors approach capacity, and
        # remap the arena indices the tracker itself holds
        cap = self.cfg.capacity
        if self._int(self.map.next_kf) > cap.client_max_kfs - 4 or \
                self._int(self.map.next_mp) > cap.client_max_mps - 2 * cap.max_keypoints:
            kf_remap, mp_remap = ms.compaction_remap(self.map)
            self.map = ms.compact_map(self.map)
            self.ref_kf = self._find_kf_slot(self.next_kf_id - 1)
            self.last_compaction = (kf_remap, mp_remap)
            if self.last_frame is not None:
                old = self.last_frame.mp
                remap = torch.as_tensor(mp_remap.astype(np.int32), device=old.device)
                new = torch.where(old >= 0, remap[old.clamp(0, remap.shape[0] - 1).long()],
                                  ms.NO_MP)
                self.last_frame = self.last_frame.replace(mp=new)

    def _local_ba(self, k: int, iters: int):
        self.stats["local_ba_calls"] += 1
        self.stats["local_ba_iters"] += iters
        return mapping.local_ba(self.map, k, self.cam, self.cfg, iters=iters)

    def _check_replaced(self, redirect):
        """CheckReplacedInLastFrame (Tracking.cpp:469): route the last
        frame's associations through the fuse pass's loser -> winner table;
        a frame left with two features on one landmark keeps the first."""
        if self.last_frame is None:
            return
        old = self.last_frame.mp
        cap = redirect.shape[0]
        new = torch.where(old >= 0, redirect[old.clamp(0, cap - 1).long()], old)
        order = torch.argsort(torch.where(new >= 0, new, cap + 1), stable=True)
        srt = new[order]
        dup_srt = torch.cat([torch.zeros(1, dtype=torch.bool, device=new.device),
                             srt[1:] == srt[:-1]]) & (srt >= 0)
        dup = torch.zeros_like(dup_srt).index_put((order,), dup_srt)
        self.last_frame = self.last_frame.replace(mp=torch.where(dup, ms.NO_MP, new))

    def _find_kf_slot(self, kf_id: int) -> int:
        kfs = self.map.kfs
        alive = kfs.valid & ~kfs.bad
        ar = torch.arange(kfs.capacity, device=kfs.kf_id.device)
        return self._int(torch.max(torch.where(alive & (kfs.kf_id == kf_id), ar, -1)))

    def _handle_lost(self, frame: Frame):
        if self.kfs_since_init < self.cfg.tracking.init_kfs:
            # young map: full reset (Tracking.cpp:248-259); ids restart at 0
            self.state = NOT_INITIALIZED
            self.map = None
            self.ref_frame = None
            self.last_frame = None
            self.has_velocity = False
            self.next_kf_id = 0
            self.kf_events.append(-1)
            self.reset_epoch += 1
        else:
            self.state = LOST
        self.n_lost_frames += 1
        self.trajectory.append(None)
        return None
