"""One agent's client: ``Tracker.process_image`` over a rendered corridor.

Set-up renders (or loads from ``portbench/.cache/frames``) the traffic's
corridor world, ``frames`` images at the configuration's camera, adds the
sensor noise of the seed, builds the program's ``Tracker`` under the
configuration's settings (the source's tracking and mapping, the stated
capacities) with its RANSAC generator seeded from the seed, and feeds it
frames until the map is initialised, ``warm_frames`` have passed and
``warm_local_bas`` local BAs have run, so that every shape of the window
has run once.  Each step then feeds the next frame as soon as the last one
is tracked; past the last frame the camera retraces the sequence
backwards, then forwards again.

The check (a sample of the window drawn from the seed):

* ``orb_mismatch``: feature slots of sampled window frames where the
  program's keypoints, octaves, descriptors or validity differ from
  ``reference.orb_ref`` on the same image (limit 0);
* ``pose_cost_gap``: sampled local-map tracking steps
  (``tracking.track_local_map``): the pose the step returns against
  ``reference.pose_ref`` solved in float64 from the associations the
  program's pose optimizer was given (the reference follows the program's
  own matching here), as the relative gap of the last round's plain cost
  at the two poses over the reference's last active set, on the
  reference's path nearest to the program's (an association that a round
  leaves at the chi2 gate to within float32's reach may fall either way);
* ``lba_cost_gap``, ``lba_self_gap``: sampled local BAs of the window
  solved again by ``reference.ba_ref`` in float64 from the problem the
  program gathered: the float64 cost of the program's result against the
  reference's final cost, and the cost the program reports against the
  float64 cost of its result, both relative.

A window frame that the tracker does not track counts as failed.  The
trajectory's error against the renderer's ground truth is not compared: no
control or planted fault moves it apart from sound runs (later local BAs
pull a frame's pose back).
"""

from __future__ import annotations

import dataclasses
import os
import random

import torch

from ccm_slam_tpu_torch import config as pconfig
from ccm_slam_tpu_torch.ops import orb
from ccm_slam_tpu_torch.runtime import tracking
from ccm_slam_tpu_torch.runtime.tracker import OK, Tracker
from ccm_slam_tpu_torch.solvers import ba, pose_opt
from ccm_slam_tpu_torch.utils.camera import Camera

from .. import trace
from ..gen.corridor import Corridor
from .gba import _worst
from ..reference import ba_ref, orb_ref, pose_ref


def _program_config(config):
    """The program's configuration as the file states it: the program's
    defaults (the source's settings) with the file's camera, extractor and
    capacities; raises where the program's tracking or mapping settings
    have moved away from the source's, which the file states."""
    d = pconfig.DEFAULT_CONFIG
    ex = {k: v for k, v in config["extractor"].items() if k != "max_keypoints"}
    cap = dict(config.get("capacity", {}), max_keypoints=config["extractor"]["max_keypoints"])
    cfg = d.replace(camera=dataclasses.replace(d.camera, **config["camera"]),
                    extractor=dataclasses.replace(d.extractor, **ex),
                    capacity=dataclasses.replace(d.capacity, **cap))
    for section in ("tracking", "mapping"):
        have = getattr(cfg, section)
        for key, want in config[section].items():
            if getattr(have, key) != want:
                raise RuntimeError(f"the program's {section}.{key} is {getattr(have, key)}, "
                                   f"the source states {want}")
    return cfg


def control(cell):
    """The control, one precision below the configuration's float32 with
    TF32 off: the program with TF32 on for the window (it reaches the
    extractor's resize products and the local BA's Schur products)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def _pose_skipped(fn):
    def broken(m, frame, *a, **kw):
        m2, f2, n, best = fn(m, frame, *a, **kw)
        return m2, f2.replace(R_cw=frame.R_cw, t_cw=frame.t_cw), n, best
    return broken


def _local_ba_unchanged(fn):
    def broken(prob, *a, **kw):
        out = fn(prob, *a, **kw)
        return (prob.R, prob.t, prob.X, *out[3:])
    return broken


# Faults planted under the timed path, for the calibration's readings:
# name -> (module, function, maker of the broken function).
FAULTS = {
    "pose_refinement_skipped": ("ccm_slam_tpu_torch.runtime.tracking", "track_local_map",
                                _pose_skipped),
    "local_ba_unchanged": ("ccm_slam_tpu_torch.solvers.ba", "ba_solve", _local_ba_unchanged),
}


def map_stats(m):
    """The shape of a map: live keyframes and landmarks (with two or more
    observations), observations per landmark, per keyframe and by octave,
    and the span of each landmark's observers in keyframe insertion rank."""
    kfs, mps = m.kfs, m.mps
    alive = kfs.valid & ~kfs.bad
    order = torch.where(alive, kfs.insert_order, torch.iinfo(torch.int32).max)
    rank = torch.empty_like(order)
    rank[torch.argsort(order, stable=True)] = torch.arange(order.shape[0], dtype=order.dtype,
                                                            device=order.device)
    kf = mps.obs_kf.clamp(0, kfs.capacity - 1).long()
    slot = ((torch.arange(mps.max_obs, device=kf.device)[None, :] < mps.obs_n[:, None])
            & (mps.obs_kf >= 0) & alive[kf])
    n_obs = slot.sum(1)
    live = mps.valid & ~mps.bad & (n_obs >= 2)
    r = rank[kf].float()
    span = (torch.where(slot, r, -1.0).amax(1) - torch.where(slot, r, 1e9).amin(1))[live]
    octave = kfs.octave[kf, mps.obs_feat.clamp(0, kfs.n_feat - 1).long()][slot & live[:, None]]
    hist = torch.bincount(n_obs[live], minlength=mps.max_obs + 1)
    q = torch.tensor([0.5, 0.9, 0.99], device=span.device)
    n_kf, n_mp = int(alive.sum()), int(live.sum())
    return dict(keyframes=n_kf, landmarks=n_mp, landmarks_per_kf=n_mp / n_kf,
                obs_per_landmark=float(n_obs[live].float().mean()),
                obs_per_kf=float(n_obs[live].sum()) / n_kf,
                obs_hist=hist.tolist(), span_q50_q90_q99=torch.quantile(span, q).tolist(),
                octave_hist=torch.bincount(octave, minlength=8).tolist(),
                kf_capacity=kfs.capacity, mp_capacity=mps.capacity, slots=mps.max_obs)


class Cell:
    def __init__(self, config, traffic, seed, dev, root):
        self.seed, self.dev, self.config, self.traffic = seed, dev, config, traffic
        self.cfg = _program_config(config)
        self.n = int(traffic["frames"])
        cache = os.path.join(root, "portbench", ".cache", "frames")
        self.seq = Corridor(traffic["world_seed"], self.n, traffic["span"], config["camera"], dev,
                            cache_dir=cache)
        self.frames = self.seq.frames(seed)
        self.tracker = Tracker(cfg=self.cfg, cam=Camera.from_config(self.cfg.camera, dev),
                               device=dev, rng=torch.Generator(device=dev).manual_seed(seed))
        self.s = 0          # steps fed
        self.window0 = None  # first step of the measured or traced work
        self.extracts, self.solves, self.poses = [], [], []
        self._pose_in = None
        self.patches = trace.Patches()
        self.patches.wrap(orb, "extract", trace.recorded(self._on_extract))
        self.patches.wrap(ba, "ba_solve", trace.recorded(self._on_solve))
        self.patches.wrap(pose_opt, "optimize_pose", trace.recorded(self._on_pose_opt))
        self.patches.wrap(tracking, "track_local_map", self._local_map_recorded)
        self._warm(int(traffic["warm_frames"]), int(traffic["warm_local_bas"]))
        self.window0 = self.s
        self.extracts, self.solves, self.poses = [], [], []

    def _local_map_recorded(self, fn):
        def call(m, frame, *a, **kw):
            self._pose_in = None
            out = fn(m, frame, *a, **kw)
            if self._pose_in is not None:
                self.poses.append((self._pose_in, out[1].R_cw, out[1].t_cw))
            self._pose_in = None
            return out
        return call

    def _on_pose_opt(self, args, kw, out):
        self._pose_in = (args, kw)

    def _on_extract(self, args, kw, out):
        self.extracts.append((self.s, out))

    def _on_solve(self, args, kw, out):
        self.solves.append((args, kw, out[:4]))

    def frame_of(self, s):
        u = s % (2 * (self.n - 1))
        return u if u < self.n else 2 * (self.n - 1) - u

    def step(self):
        i = self.frame_of(self.s)
        self.tracker.process_image(self.frames[i], self.s / self.config["camera"]["fps"])
        self.s += 1
        return 1

    def _warm(self, frames, local_bas):
        while (self.s < frames or self.tracker.state != OK
               or self.tracker.stats["local_ba_calls"] < local_bas):
            if self.s >= 2 * self.n:
                raise RuntimeError(f"the tracker is not warm after {self.s} frames (state "
                                   f"{self.tracker.state}, {self.tracker.stats['local_ba_calls']}"
                                   " local BAs)")
            self.step()

    def end_to_end(self, name, window_s, n):
        if name == "frames_per_s":
            return n / window_s
        raise KeyError(name)

    def reset_counters(self):
        self._c0 = (self.s, dict(self.tracker.stats))

    def counters(self):
        s0, st0 = self._c0
        st = self.tracker.stats
        return dict(frames=self.s - s0, keyframes=st["kf_created"] - st0["kf_created"],
                    local_bas=st["local_ba_calls"] - st0["local_ba_calls"],
                    landmarks=st["mp_created"] - st0["mp_created"])

    def check(self):
        self.patches.restore()
        traj = self.tracker.trajectory
        failed = sum(e is None for e in traj[self.window0:])
        rng = random.Random(self.seed)
        picks = self.traffic["samples"]
        extracts = rng.sample(self.extracts, min(picks["orb_frames"], len(self.extracts)))
        solves = rng.sample(self.solves, min(picks["local_bas"], len(self.solves)))
        poses = rng.sample(self.poses, min(picks["local_map_poses"], len(self.poses)))
        self.extracts = self.solves = self.poses = None
        ex = self.config["extractor"]
        mism = 0
        for s, f in extracts:
            ref = orb_ref.extract(self.frames[self.frame_of(s)], ex["n_features"], ex["n_levels"],
                                  ex["scale_factor"], ex["ini_th_fast"], ex["min_th_fast"],
                                  ex["cell_size"], ex["max_keypoints"])
            prog = dict(xy=f.xy, octave=f.octave, desc=f.desc, valid=f.valid)
            mism += orb_ref.mismatched_slots(prog, ref)[0]
        lba_gap, lba_self = [], []
        for args, kw, (R, t, X, cost) in solves:
            p = args[0]
            iters = kw.get("iters", args[1] if len(args) > 1 else 20)
            m64 = ba_ref.as_dtype(dict(R=p.R, t=p.t, X=p.X, cam_idx=p.cam_idx, uv=p.uv,
                                       sigma2=p.sigma2, obs_valid=p.obs_valid,
                                       cam_fixed=p.cam_fixed, point_valid=p.point_valid,
                                       intr=torch.stack([p.fx, p.fy, p.cx, p.cy])), torch.float64)
            ref = ba_ref.solve(m64, iters, kw.get("cg_iters", 16))
            c = float(ba_ref.Problem(m64).cost(R.double(), t.double(), X.double()))
            lba_gap.append(abs(c - float(ref["cost"])) / float(ref["cost"]))
            lba_self.append(abs(float(cost) - c) / c)
        pose_gap = [self._pose_gap(*p) for p in poses]
        limits = self.traffic["checks"]
        return failed, dict(
            orb_mismatch=(float(mism), limits["orb_mismatch"]),
            pose_cost_gap=(_worst(pose_gap), limits["pose_cost_gap"]),
            lba_cost_gap=(_worst(lba_gap), limits["lba_cost_gap"]),
            lba_self_gap=(_worst(lba_self), limits["lba_self_gap"]))

    @staticmethod
    def _pose_gap(inputs, R, t):
        """Relative gap of the last round's cost at the program's pose over
        the reference's optimum, from the optimizer's own inputs, on the
        reference's path nearest to it (``pose_ref.solve_all``)."""
        (R0, t0, X, uv, valid, sigma2, fx, fy, cx, cy), kw = inputs[0][:10], inputs[1]
        cpu = [x.cpu() if torch.is_tensor(x) else x for x in (R0, t0, X, uv, valid, sigma2)]
        intr = [float(v) for v in (fx, fy, cx, cy)]
        R, t = R.cpu(), t.cpu()
        return min(abs(pose_ref.cost_at(R, t, cpu[2], cpu[3], cpu[5], active, intr) - c_ref)
                   / max(c_ref, 1e-12)
                   for _, _, active, c_ref in pose_ref.solve_all(
                       *cpu, intr, rounds=kw.get("rounds", 4), iters=kw.get("iters_per_round", 10)))

    def release(self):
        self.patches.restore()
        self.tracker = self.frames = None
