"""KITTI odometry dataset reading (monocular, grayscale cam0).

Counterpart of ``ccm_slam_tpu/io/kitti.py``.  The reference ships KITTI
camera configs and launch files (cslam/conf/kitti_mono*.yaml,
cslam/launch/KITTI/, readme.md:166-170); this reads the plain odometry
layout directly:

    <root>/sequences/<seq>/image_0/??????.png
    <root>/sequences/<seq>/times.txt
    <root>/sequences/<seq>/calib.txt        (P0 projection -> fx fy cx cy)
    <root>/poses/<seq>.txt                  (ground truth, seqs 00-10)

Ground-truth rows are 3x4 row-major cam0-to-world matrices.  Host-side
numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .euroc import EurocFrame


@dataclass
class KittiSequence:
    root: str           # dataset root containing sequences/ (and poses/)
    seq: str = "00"

    def _seq_dir(self):
        return os.path.join(self.root, "sequences", self.seq)

    def calibration(self):
        """(fx, fy, cx, cy) from the P0 line of calib.txt (rectified,
        distortion-free: the kitti_mono yamls carry zero k1..p2)."""
        with open(os.path.join(self._seq_dir(), "calib.txt")) as f:
            for line in f:
                if line.startswith("P0:"):
                    P = np.array(line.split(":", 1)[1].split(), np.float64).reshape(3, 4)
                    return float(P[0, 0]), float(P[1, 1]), float(P[0, 2]), float(P[1, 2])
        raise ValueError("calib.txt has no P0 line")

    def _times(self):
        with open(os.path.join(self._seq_dir(), "times.txt")) as f:
            return [float(line) for line in f if line.strip()]

    def frame_index(self):
        """[(timestamp_s, image_path), ...] in sequence order."""
        img_dir = os.path.join(self._seq_dir(), "image_0")
        return [(t, os.path.join(img_dir, f"{i:06d}.png")) for i, t in enumerate(self._times())]

    def frames(self, start: float = 0.0, limit: Optional[int] = None) -> Iterator[EurocFrame]:
        """Grayscale frames from time ``start`` on (at most ``limit``)."""
        from PIL import Image

        n = 0
        for ts, path in self.frame_index():
            if ts < start:
                continue
            img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
            yield EurocFrame(timestamp=ts, image=img)
            n += 1
            if limit is not None and n >= limit:
                return

    def ground_truth(self):
        """(timestamps [T], positions [T,3], R_wc [T,3,3]) from poses/<seq>.txt."""
        mats = np.loadtxt(os.path.join(self.root, "poses", f"{self.seq}.txt")).reshape(-1, 3, 4)
        times = np.asarray(self._times())
        n = min(len(times), len(mats))
        return times[:n], mats[:n, :, 3].astype(np.float32), mats[:n, :, :3].astype(np.float32)
