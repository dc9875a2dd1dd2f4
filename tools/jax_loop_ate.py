"""The JAX package's standalone loop-closing system on the rendered loop, on the CPU.

    python3 tools/jax_loop_ate.py [--factor 1.0] [--frames 340]

Drives the JAX package's ``StandaloneSystem.process_image`` over
``RenderedSequence("loop", seed=0, n_frames=340, span=(0, 1.08))`` with
``rendered_ci_config(factor)`` and ``n_words=1024`` (at 1.0: 752x480, 1000
features, 8 levels, 1,024 slots, 24,576 landmark slots, 160 keyframe slots,
K=16), then runs ``run_gba(40)`` and prints one JSON line: frames tracked,
whether the tracker ended LOST, loops closed, GBA runs, keyframes, the
keyframe ATE after Sim(3) alignment against the renderer's ground truth
before and after the final GBA, the span it is measured over and the gate
of ``tests/test_rendered_loop.py`` (0.115 x span + 0.05).  ``chip_smoke.py``
chooses its phase-12 width from this script's output at ``--factor 1.0``.
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
from ccm_slam_tpu.runtime.standalone import StandaloneSystem  # noqa: E402
from ccm_slam_tpu.runtime.tracker import LOST  # noqa: E402
from ccm_slam_tpu.utils.camera import Camera  # noqa: E402


def kf_ate(sys_, seq):
    """(rmse, span, keyframes) of the alive keyframes against ground truth."""
    m = sys_.tracker.map
    alive = np.asarray(m.kfs.valid & ~m.kfs.bad)
    idx = np.where(alive)[0]
    idx = idx[np.argsort(np.asarray(m.kfs.kf_id)[idx])]
    ts = np.asarray(m.kfs.timestamp)[idx]
    est = np.asarray(camera_centers(m.kfs.R_cw[idx], m.kfs.t_cw[idx]))
    gt_ts, gt_pos, _ = seq.ground_truth()
    gt = gt_pos[np.clip(np.searchsorted(gt_ts, ts), 0, len(gt_ts) - 1)]
    rmse, _ = ate_rmse(est, gt, align="sim3")
    return rmse, float(np.linalg.norm(gt.max(0) - gt.min(0))), int(alive.sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--factor", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=340)
    args = ap.parse_args()
    cfg = rendered_ci_config(factor=args.factor)
    cam = Camera.from_config(cfg.camera)
    n = args.frames
    seq = RenderedSequence(world="loop", seed=0, n_frames=340, span=(0.0, 1.08),
                           cam=cfg.camera)
    sys_ = StandaloneSystem(cfg=cfg, cam=cam, n_words=1024)
    tracked = 0
    t0 = time.perf_counter()
    for i, fr in enumerate(seq.frames()):
        if i >= n:
            break
        if sys_.process_image(jnp.asarray(fr.image), fr.timestamp) is not None:
            tracked += 1
        if i % 20 == 0:
            print(f"frame {i}: tracked {tracked}, keyframes "
                  f"{sys_.tracker.stats['kf_created']}, loops {sys_.stats['loops_closed']}, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    lost = sys_.tracker.state == LOST
    ate_before, _, _ = kf_ate(sys_, seq)
    sys_.run_gba(40)
    rmse, span, n_kf = kf_ate(sys_, seq)
    m = sys_.tracker.map
    le = np.asarray(m.kfs.loop_edges)
    alive = np.asarray(m.kfs.valid & ~m.kfs.bad)
    print(json.dumps(dict(
        factor=args.factor, frames=n, tracked=tracked, lost=bool(lost),
        loops_closed=sys_.stats["loops_closed"], gba_runs=sys_.stats["gba_runs"],
        loop_edge_kfs=int(((le >= 0).any(1) & alive).sum()), keyframes=n_kf,
        kf_created=sys_.tracker.stats["kf_created"], ate_before_final_gba_m=ate_before,
        ate_m=rmse, span_m=span, gate_m=0.115 * span + 0.05,
        seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
