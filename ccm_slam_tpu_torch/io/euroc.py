"""EuRoC MAV dataset reading (ASL layout), without ROS.

Counterpart of ``ccm_slam_tpu/io/euroc.py``, which replaces the reference's
rosbag + cv_bridge input path (readme.md:144-163, ``rosbag play
MH_01_easy.bag``): reads ``mav0/cam0/data.csv`` and its PNGs and the ground
truth ``mav0/state_groundtruth_estimate0/data.csv`` directly.  Host-side
numpy: the tracker moves each image to its device.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class EurocFrame:
    timestamp: float   # seconds
    image: np.ndarray  # [H,W] float32 grayscale 0..255


@dataclass
class EurocSequence:
    root: str  # path containing mav0/
    cam: str = "cam0"

    def _cam_dir(self):
        return os.path.join(self.root, "mav0", self.cam)

    def frame_index(self):
        """[(timestamp_s, image_path), ...] sorted by time."""
        out = []
        with open(os.path.join(self._cam_dir(), "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts_ns, fname = row[0].strip(), row[1].strip()
                out.append((int(ts_ns) * 1e-9, os.path.join(self._cam_dir(), "data", fname)))
        out.sort()
        return out

    def frames(self, start: float = 0.0, limit: Optional[int] = None) -> Iterator[EurocFrame]:
        """Grayscale frames in time order; ``start`` skips the first seconds
        (the multi-agent protocol's staggered starts, readme.md:152-155)."""
        from PIL import Image

        idx = self.frame_index()
        t0 = idx[0][0] if idx else 0.0
        n = 0
        for ts, path in idx:
            if ts - t0 < start:
                continue
            img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
            yield EurocFrame(timestamp=ts, image=img)
            n += 1
            if limit is not None and n >= limit:
                return

    def ground_truth(self):
        """(timestamps [T], positions [T,3], quaternions wxyz [T,4]) from
        state_groundtruth_estimate0 (the evo reference trajectory)."""
        path = os.path.join(self.root, "mav0", "state_groundtruth_estimate0", "data.csv")
        ts, pos, quat = [], [], []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                pos.append([float(row[1]), float(row[2]), float(row[3])])
                quat.append([float(row[4]), float(row[5]), float(row[6]), float(row[7])])
        return np.asarray(ts), np.asarray(pos, np.float32), np.asarray(quat, np.float32)


def associate_gt(est_ts, gt_ts, gt_pos, max_dt: float = 0.02):
    """Nearest-timestamp association of estimated poses to ground truth
    (within ``max_dt`` seconds).  Returns (est_mask, matched_gt_pos)."""
    out_pos = np.zeros((len(est_ts), 3), np.float32)
    mask = np.zeros(len(est_ts), bool)
    for i, t in enumerate(est_ts):
        j = int(np.searchsorted(gt_ts, t))
        best, bd = -1, max_dt
        for cand in (j - 1, j):
            if 0 <= cand < len(gt_ts) and abs(gt_ts[cand] - t) <= bd:
                best, bd = cand, abs(gt_ts[cand] - t)
        if best >= 0:
            out_pos[i] = gt_pos[best]
            mask[i] = True
    return mask, out_pos
