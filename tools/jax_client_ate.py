"""The JAX package's single-agent client on rendered corridor frames, on the CPU.

    python3 tools/jax_client_ate.py [--factor 1.0] [--frames 200]

Drives the JAX package's ``Tracker.process_image`` over
``RenderedSequence("corridor", seed=0, n_frames=200, span=(0, 0.22))`` with
``rendered_ci_config(factor)`` (at 1.0: 752x480, 1000 features, 8 levels,
1,024 slots, 24,576 landmark slots, K=16) and prints one JSON line: frames
tracked, whether the tracker ended LOST, keyframes, and the keyframe ATE
after Sim(3) alignment against the renderer's ground truth with the span it
is measured over -- the quantities of ``tests/test_rendered_ate.py``.
``chip_smoke.py`` takes ``JAX_CLIENT_ATE_M`` (its phase-11 gate) from this
script's output at ``--factor 1.0``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

from ccm_slam_tpu.config import rendered_ci_config  # noqa: E402
from ccm_slam_tpu.io.rendered import RenderedSequence  # noqa: E402
from ccm_slam_tpu.io.trajectory import ate_rmse, camera_centers  # noqa: E402
from ccm_slam_tpu.runtime.tracker import LOST, Tracker  # noqa: E402
from ccm_slam_tpu.utils.camera import Camera  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--factor", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args()
    cfg = rendered_ci_config(factor=args.factor)
    cam = Camera.from_config(cfg.camera)
    n = args.frames
    seq = RenderedSequence(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22),
                           cam=cfg.camera)
    tr = Tracker(cfg=cfg, cam=cam)
    tracked = 0
    t0 = time.perf_counter()
    for i, fr in enumerate(seq.frames()):
        if i >= n:
            break
        if tr.process_image(jnp.asarray(fr.image), fr.timestamp) is not None:
            tracked += 1
        if i % 20 == 0:
            print(f"frame {i}: tracked {tracked}, keyframes {tr.stats['kf_created']}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    m = tr.map
    alive = np.asarray(m.kfs.valid & ~m.kfs.bad)
    idx = np.where(alive)[0]
    idx = idx[np.argsort(np.asarray(m.kfs.kf_id)[idx])]
    ts = np.asarray(m.kfs.timestamp)[idx]
    est = np.asarray(camera_centers(m.kfs.R_cw[idx], m.kfs.t_cw[idx]))
    gt_ts, gt_pos, _ = seq.ground_truth()
    gt = gt_pos[np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)]
    rmse, _ = ate_rmse(est, gt, align="sim3")
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    print(json.dumps(dict(factor=args.factor, frames=n, tracked=tracked,
                          lost=tr.state == LOST, keyframes=int(alive.sum()),
                          kf_created=tr.stats["kf_created"], ate_m=rmse, span_m=span,
                          gate_m=0.010 * span + 0.02,
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
