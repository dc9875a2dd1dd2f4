"""Per-frame measurement container (the reference's ``Frame``,
cslam/src/Frame.cpp): undistorted keypoints + descriptors + per-slot landmark
associations, as a dataclass of tensors.  Counterpart of
``ccm_slam_tpu/runtime/frame.py``."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..models.map_store import NO_MP
from ..ops.orb import FrameFeatures
from ..solvers.reproj import level_sigma2


@dataclass(frozen=True)
class Frame:
    timestamp: torch.Tensor  # scalar f32
    xy: torch.Tensor         # [N,2] undistorted level-0 pixels
    desc: torch.Tensor       # [N,32] uint8
    octave: torch.Tensor     # [N] int32
    angle: torch.Tensor      # [N] f32 radians
    sigma2: torch.Tensor     # [N] detection variance (1.2^(2*octave))
    valid: torch.Tensor      # [N] bool
    R_cw: torch.Tensor       # [3,3]
    t_cw: torch.Tensor       # [3]
    mp: torch.Tensor         # [N] int32 landmark arena idx or NO_MP

    @property
    def n_feat(self):
        return self.xy.shape[0]

    @property
    def n(self):
        return torch.sum(self.valid.to(torch.int32))

    def replace(self, **kw) -> "Frame":
        return dataclasses.replace(self, **kw)


def build_frame(feats: FrameFeatures, cam, timestamp, scale_factor: float = 1.2) -> Frame:
    """Undistort raw detections and wrap them as a Frame (on their device)."""
    dev = feats.xy.device
    f32 = dict(dtype=torch.float32, device=dev)
    return Frame(
        timestamp=torch.tensor(float(timestamp), **f32),
        xy=cam.undistort_pixels(feats.xy),
        desc=feats.desc,
        octave=feats.octave,
        angle=feats.angle,
        sigma2=level_sigma2(feats.octave, scale_factor),
        valid=feats.valid,
        R_cw=torch.eye(3, **f32),
        t_cw=torch.zeros(3, **f32),
        mp=torch.full((feats.xy.shape[0],), NO_MP, dtype=torch.int32, device=dev),
    )
