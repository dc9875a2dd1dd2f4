"""The JAX package's two-view bootstrap on rendered corridor frames, on the CPU.

    python3 tools/jax_init_pair.py [--pairs 0:4,0:6,0:8] [--factor 1.0]

Renders ``RenderedSequence("corridor", seed=0, n_frames=200, span=(0, 0.22))``
(the numpy backend) through the EuRoC camera scaled by ``--factor``, runs the
JAX package's front-end on each frame pair as the tracker does at start-up
(``orb.extract`` with min(2 x 1000, 1024) features, ``build_frame``,
``search_for_initialization``, ``initialize_two_view`` with the tracker's
first key) and prints, per pair, the match count, success, the model used,
good landmarks and the rotation and translation-direction errors against the
renderer's ground truth.  ``chip_smoke.py`` takes its bootstrap pair and its
error bounds from this script's output at ``--factor 1.0``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

from ccm_slam_tpu.config import CameraConfig, scaled_camera  # noqa: E402
from ccm_slam_tpu.io.rendered import RenderedSequence  # noqa: E402
from ccm_slam_tpu.ops import initializer, matching, orb  # noqa: E402
from ccm_slam_tpu.runtime.frame import build_frame  # noqa: E402
from ccm_slam_tpu.utils.camera import Camera  # noqa: E402


def relative_gt(seq, i, j):
    """(R, t) with x_j = R x_i + t, from the renderer's camera-to-world poses."""
    _, o_i, R_i = seq.gt_pose(i)
    _, o_j, R_j = seq.gt_pose(j)
    R = R_j.T @ R_i
    t = R_j.T @ (o_i - o_j)
    return R.astype(np.float64), t.astype(np.float64)


def rot_err_deg(R, R_gt):
    c = (np.trace(np.asarray(R, np.float64) @ R_gt.T) - 1.0) / 2.0
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def dir_err_deg(t, t_gt):
    t = np.asarray(t, np.float64)
    c = float(t @ t_gt) / max(np.linalg.norm(t) * np.linalg.norm(t_gt), 1e-12)
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", default="0:4,0:6,0:8,0:10")
    ap.add_argument("--factor", type=float, default=1.0)
    args = ap.parse_args()
    cfg_cam = CameraConfig() if args.factor == 1.0 else scaled_camera(factor=args.factor)
    seq = RenderedSequence(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22),
                           cam=cfg_cam, backend="numpy")
    cam = Camera.from_config(cfg_cam)
    pairs = [tuple(int(x) for x in p.split(":")) for p in args.pairs.split(",")]
    n_features = min(2 * 1000, 1024)
    key = jax.random.split(jax.random.PRNGKey(42))[1]  # Tracker._initialize's key

    frames = {}
    for i in sorted({i for p in pairs for i in p}):
        t0 = time.perf_counter()
        img = jnp.asarray(seq.render_frame(i))
        feats = orb.extract(img, n_features=n_features, n_levels=8, scale_factor=1.2,
                            ini_th=20.0, min_th=7.0, cell=30, capacity=1024)
        frames[i] = build_frame(feats, cam, seq.gt_pose(i)[0], 1.2)
        print(f"frame {i}: {int(feats.n)} features "
              f"({time.perf_counter() - t0:.1f} s render+extract)", flush=True)

    for i, j in pairs:
        f1, f2 = frames[i], frames[j]
        idx, _, ok = matching.search_for_initialization(
            f1.xy, f1.desc, f1.valid, f1.angle, f1.octave,
            f2.xy, f2.desc, f2.valid, f2.angle, f2.octave)
        p2 = f2.xy[jnp.clip(idx, 0, f2.xy.shape[0] - 1)]
        out = initializer.initialize_two_view(key, f1.xy, p2, ok, cam.K, sigma=1.0)
        R_gt, t_gt = relative_gt(seq, i, j)
        res = dict(pair=[i, j], factor=args.factor, matches=int(jnp.sum(ok)),
                   success=bool(out["success"]), used_h=bool(out["used_h"]),
                   n_good=int(out["n_good"]),
                   rot_err_deg=rot_err_deg(np.asarray(out["R"]), R_gt),
                   dir_err_deg=dir_err_deg(np.asarray(out["t"]), t_gt))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
