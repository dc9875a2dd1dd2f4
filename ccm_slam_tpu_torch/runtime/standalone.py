"""Standalone single-agent SLAM: tracking + loop closure + global BA in one
process (PyTorch).

Counterpart of ``ccm_slam_tpu/runtime/standalone.py`` (BASELINE config 2,
the reference's client and server run on one machine for one agent): a
``Tracker`` and a ``LoopFinder`` over the same map arena; each new keyframe
is offered to the loop closer, a closure is followed by a global BA (the
two oldest keyframes fixed as the gauge), and redundant keyframes are culled
(KeyFrameCullingV3).  The vocabulary is given, or bootstrapped from the map's
descriptors at the first keyframe event with a ``torch.Generator`` seeded 7
(the reference seeds ``PRNGKey(7)``).

``stats`` counts loops closed, GBA runs and iterations, and the
vocabulary's training iterations.
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
from ..solvers import ba
from ..utils.camera import Camera
from . import mapping
from .loop_closing import LoopFinder
from .tracker import Tracker
from .tracking import apply_ba_result, build_ba_problem

VOCAB_ITERS = 6


@dataclass
class StandaloneSystem:
    cfg: SystemConfig
    cam: Camera
    vocab: Optional[bow.Vocabulary] = None
    n_words: int = 1024
    device: Optional[object] = None  # the card unless told otherwise
    tracker: Tracker = None
    finder: LoopFinder = None
    gba_after_loop_iters: int = 20
    stats: dict = field(default_factory=lambda: {
        "loops_closed": 0, "gba_runs": 0, "gba_iters": 0, "vocab_iters": 0})

    def __post_init__(self):
        if self.tracker is None:
            self.tracker = Tracker(cfg=self.cfg, cam=self.cam, device=self.device)
        self.device = self.tracker.device

    def _ensure_finder(self):
        if self.finder is not None:
            return
        if self.vocab is None:
            # bootstrap the codebook from the map's current descriptors
            m = self.tracker.map
            gen = torch.Generator(device=self.device).manual_seed(7)
            self.vocab = bow.train_vocabulary(
                m.kfs.desc.reshape(-1, 32), m.kfs.feat_valid.reshape(-1), n_words=self.n_words,
                iters=VOCAB_ITERS, generator=gen)
            self.stats["vocab_iters"] += VOCAB_ITERS
        self.finder = LoopFinder(
            cfg=self.cfg, cam=self.cam, vocab=self.vocab,
            db=kdb.empty_db(self.cfg.capacity.client_max_kfs, self.vocab.n_words, self.device),
            map_id=0)

    def process_frame(self, frame):
        """Track one frame; on a new keyframe attempt loop closure and run GBA
        after a closure.  Returns the tracked Frame or None."""
        n_kf_before = self.tracker.stats["kf_created"]
        out = self.tracker.process_frame(frame)
        self._post_track(n_kf_before)
        return out

    def process_image(self, img, timestamp: float):
        n_kf_before = self.tracker.stats["kf_created"]
        out = self.tracker.process_image(img, timestamp)
        self._post_track(n_kf_before)
        return out

    def _post_track(self, n_kf_before: int):
        if self.tracker.map is None:
            return
        self._handle_compaction()
        if self.tracker.stats["kf_created"] > n_kf_before:
            self._ensure_finder()
            new_arena = self.tracker.ref_kf
            m, closed = self.finder.try_close(self.tracker.map, new_arena)
            self.tracker.map = m
            if closed:
                self.stats["loops_closed"] += 1
                self.run_gba(self.gba_after_loop_iters)
                # poses jumped: rebuild the velocity model next frame and hand
                # tracking the post-GBA pose of the loop keyframe
                m2 = self.tracker.map
                self.tracker.has_velocity = False
                self.tracker.last_frame = self.tracker.last_frame.replace(
                    R_cw=m2.kfs.R_cw[new_arena], t_cw=m2.kfs.t_cw[new_arena])
            self._cull_redundant()

    def _handle_compaction(self):
        """An arena compaction permutes keyframe slots: remap the database's
        rows and restart the consistency bookkeeping."""
        if self.tracker.last_compaction is None:
            return
        kf_remap, _ = self.tracker.last_compaction
        self.tracker.last_compaction = None
        if self.finder is not None:
            self.finder.db = kdb.remap(self.finder.db, kf_remap)
            self.finder.prev_groups = []

    def _cull_redundant(self):
        """Keyframe redundancy culling (KeyFrameCullingV3): the standalone
        system is client and server in one, so the server's culling runs
        here; culled rows leave the place-recognition database."""
        if self.cfg.mapping.red_thres >= 1.0:
            return
        m, n = mapping.cull_redundant_keyframes(self.tracker.map, self.cfg)
        if self.tracker._int(n) > 0:
            self.tracker.map = m
            if self.finder is not None:
                self.finder.db = kdb.erase(self.finder.db, m.kfs.valid & m.kfs.bad)

    def run_gba(self, iters: int = 20):
        """Full-map BA with the two oldest keyframes as gauge anchors; returns
        the final cost."""
        if self.tracker.map is None:
            raise RuntimeError("run_gba before initialization: no map yet")
        m = self.tracker.map
        alive = m.kfs.valid & ~m.kfs.bad
        order = torch.where(alive, m.kfs.insert_order, ms._I32_MAX)
        oldest2 = torch.argsort(order, stable=True)[:2]
        fixed = torch.zeros(m.kfs.capacity, dtype=torch.bool, device=alive.device).index_put(
            (oldest2,), torch.ones(2, dtype=torch.bool, device=alive.device))
        prob = build_ba_problem(m, self.cam, fixed_mask=fixed)
        R, t, X, cost, _ = ba.ba_solve(prob, iters=iters)
        self.tracker.map = apply_ba_result(m, R, t, X, moved_kf_mask=~fixed & alive)
        self.stats["gba_runs"] += 1
        self.stats["gba_iters"] += iters
        return float(cost)

    def keyframe_trajectory(self):
        """(timestamps, R_cw, t_cw) of the alive keyframes by keyframe id, as
        numpy arrays (the KF_GBA_0.csv data)."""
        m = self.tracker.map
        alive = (m.kfs.valid & ~m.kfs.bad).cpu().numpy()
        idxs = np.where(alive)[0]
        idxs = idxs[np.argsort(m.kfs.kf_id.cpu().numpy()[idxs], kind="stable")]
        return (m.kfs.timestamp.cpu().numpy()[idxs], m.kfs.R_cw.cpu().numpy()[idxs],
                m.kfs.t_cw.cpu().numpy()[idxs])
