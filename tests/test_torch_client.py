"""The port's Tracker end to end on the CPU, on the synthetic arc of
tests/test_tracking_e2e.py (60 frames, 256 feature slots), held to that
file's gates: >= 85% of frames tracked, >= 3 keyframes created, ATE < 5 cm
after Sim(3) alignment, and map consistency (forward links match reverse
observations; ``check_structure`` finds nothing)."""

import numpy as np
import pytest
import torch

from ccm_slam_tpu_torch.config import CameraConfig, CapacityConfig, ExtractorConfig, SystemConfig
from ccm_slam_tpu_torch.io.trajectory import ate_rmse, camera_centers
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.runtime.frame import Frame
from ccm_slam_tpu_torch.runtime.tracker import OK, Tracker
from ccm_slam_tpu_torch.solvers.reproj import level_sigma2
from ccm_slam_tpu_torch.utils.camera import Camera
from ccm_slam_tpu_torch.utils.lie import SE3, se3_exp

N_SLOTS = 256


def small_config():
    return SystemConfig(
        extractor=ExtractorConfig(n_features=N_SLOTS, n_levels=1),
        capacity=CapacityConfig(max_keypoints=N_SLOTS, client_max_kfs=24, client_max_mps=2048,
                                max_obs_per_mp=12, covis_neighbors=8),
    )


def make_world(seed=0, n=600):
    """tests/test_tracking_e2e.make_world: <= 256 points visible per frame,
    depths 3-8 m."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-5, 7, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(3.0, 8.0, n)
    return pts, rng.randint(0, 256, (n, 32), dtype=np.uint8)


def make_trajectory(n_frames=60):
    """A smooth sideways arc with slight forward motion and yaw (T_cw)."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        xi = torch.tensor([2.0 * s, 0.05 * np.sin(4 * s), 0.6 * s, 0.0, 0.15 * s, 0.0],
                          dtype=torch.float32)
        R, t = se3_exp(xi)
        poses.append(SE3(R=R, t=t).inverse())
    return poses


def render_frame(points, desc_w, T_cw, cam, rng, t, noise_px=0.3, flip_bits=3):
    Xc = T_cw.apply(torch.as_tensor(points)).numpy()
    z = Xc[:, 2]
    uv = np.stack([float(cam.fx) * Xc[:, 0] / np.maximum(z, 1e-6) + float(cam.cx),
                   float(cam.fy) * Xc[:, 1] / np.maximum(z, 1e-6) + float(cam.cy)], -1)
    vis = (z > 0.5) & (uv[:, 0] > 10) & (uv[:, 0] < 742) & (uv[:, 1] > 10) & (uv[:, 1] < 470)
    idx = np.where(vis)[0][:N_SLOTS]
    rng.shuffle(idx)
    n = len(idx)
    xy = np.zeros((N_SLOTS, 2), np.float32)
    xy[:n] = uv[idx] + rng.randn(n, 2) * noise_px
    d = desc_w[idx].copy()
    for _ in range(flip_bits):
        byte = rng.randint(0, 32, n)
        bit = rng.randint(0, 8, n)
        d[np.arange(n), byte] ^= (1 << bit).astype(np.uint8)
    desc = np.zeros((N_SLOTS, 32), np.uint8)
    desc[:n] = d
    valid = np.zeros(N_SLOTS, bool)
    valid[:n] = True
    octave = torch.zeros(N_SLOTS, dtype=torch.int32)
    return Frame(timestamp=torch.tensor(t), xy=torch.as_tensor(xy), desc=torch.as_tensor(desc),
                 octave=octave, angle=torch.zeros(N_SLOTS), sigma2=level_sigma2(octave),
                 valid=torch.as_tensor(valid), R_cw=torch.eye(3), t_cw=torch.zeros(3),
                 mp=torch.full((N_SLOTS,), ms.NO_MP, dtype=torch.int32))


@pytest.fixture(scope="module")
def tracked_run():
    cfg = small_config()
    cam = Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")
    points, desc_w = make_world()
    poses = make_trajectory(60)
    rng = np.random.RandomState(7)
    tracker = Tracker(cfg=cfg, cam=cam, device="cpu")
    results = [tracker.process_frame(render_frame(points, desc_w, T, cam, rng, i * 0.05))
               for i, T in enumerate(poses)]
    return tracker, results, poses


def test_initializes_and_tracks(tracked_run):
    tracker, results, _ = tracked_run
    assert tracker.state == OK
    n_tracked = sum(r is not None for r in results)
    assert n_tracked >= 0.85 * len(results), n_tracked


def test_keyframes_created(tracked_run):
    tracker, _, _ = tracked_run
    assert tracker.stats["kf_created"] >= 3
    assert int(tracker.map.next_mp) > 100
    assert tracker.stats["host_reads"] > 0 and tracker.stats["local_ba_calls"] >= 1


def test_trajectory_accuracy(tracked_run):
    """ATE < 5 cm after Sim(3) alignment (tests/test_tracking_e2e.py:160)."""
    _, results, poses = tracked_run
    est = np.stack([camera_centers(r.R_cw, r.t_cw).numpy() for r in results if r is not None])
    gt = np.stack([camera_centers(T.R, T.t).numpy() for r, T in zip(results, poses)
                   if r is not None])
    rmse, _ = ate_rmse(est, gt, align="sim3")
    assert rmse < 0.05, rmse


def test_map_consistency(tracked_run):
    tracker, _, _ = tracked_run
    m = tracker.map
    assert ms.check_structure(m) == []
    mp_idx, obs_kf = m.kfs.mp_idx.numpy(), m.mps.obs_kf.numpy()
    obs_feat, obs_n, bad = m.mps.obs_feat.numpy(), m.mps.obs_n.numpy(), m.mps.bad.numpy()
    checked = 0
    for k in range(min(int(m.next_kf), 6)):
        for f in range(N_SLOTS):
            p = mp_idx[k, f]
            if p >= 0 and not bad[p]:
                assert ((obs_kf[p][:obs_n[p]] == k) & (obs_feat[p][:obs_n[p]] == f)).any()
                checked += 1
    assert checked > 50


def test_trimming_is_refused(tracked_run):
    """Trimming is refused for keyframes not yet sent and acked (the
    CanBeForgotten gate, ``trimmable`` all False): nothing is erased and the
    keyframes beyond the window are held; with every keyframe trimmable the
    same window erases them.  The Tracker takes ``enable_trimming`` with
    its ``trim_mask_fn``."""
    import dataclasses

    from ccm_slam_tpu_torch.runtime import mapping

    tracker, _, _ = tracked_run
    m = tracker.map
    cfg = small_config()
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, local_map_size=2))
    n_alive = int((m.kfs.valid & ~m.kfs.bad).sum())
    none = torch.zeros(m.kfs.capacity, dtype=torch.bool)
    held, n_trim, n_held = mapping.trim_keyframes(m, cfg, none)
    assert int(n_trim) == 0 and int(n_held) == n_alive - 2 > 0
    assert torch.equal(held.kfs.bad, m.kfs.bad)
    trimmed, n_trim, n_held = mapping.trim_keyframes(m, cfg, ~none)
    assert int(n_trim) == n_alive - 2 and int(n_held) == 0
    alive = trimmed.kfs.valid & ~trimmed.kfs.bad
    assert int(alive.sum()) == 2 and bool((trimmed.kfs.insert_order[alive] >= n_alive - 2).all())
    cam = Camera.from_config(CameraConfig(), "cpu")
    tr = Tracker(cfg=small_config(), cam=cam, device="cpu", enable_trimming=True,
                 trim_mask_fn=lambda m: torch.zeros(m.kfs.capacity, dtype=torch.bool))
    assert tr.enable_trimming
