"""Pinhole camera model with radial-tangential distortion (PyTorch).

Counterpart of ``ccm_slam_tpu/utils/camera.py``: the pipeline works on
undistorted keypoints throughout; distortion enters once, when raw
detections are undistorted (the fixed-point scheme of cv::undistortPoints).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device

_FIELDS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")


@dataclass(frozen=True)
class Camera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    bounds: torch.Tensor  # undistorted image bounds [min_x, max_x, min_y, max_y]

    @classmethod
    def from_config(cls, cfg, device=None) -> "Camera":
        """float32 scalars on ``device`` (the card unless told otherwise)."""
        dev = resolve_device(device)
        vals = {k: torch.tensor(float(getattr(cfg, k)), dtype=torch.float32, device=dev)
                for k in _FIELDS}
        cam = cls(**vals, bounds=torch.zeros(4, dtype=torch.float32, device=dev))
        return replace(cam, bounds=cam.compute_bounds(cfg.width, cfg.height))

    @property
    def device(self) -> torch.device:
        return self.fx.device

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx]),
            torch.stack([z, self.fy, self.cy]),
            torch.stack([z, z, o]),
        ])

    def project(self, xc):
        """Camera-frame points [..., 3] -> undistorted pixels [..., 2]."""
        z = xc[..., 2]
        z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = self.fx * xc[..., 0] / z_safe + self.cx
        v = self.fy * xc[..., 1] / z_safe + self.cy
        return torch.stack([u, v], dim=-1)

    def backproject(self, uv, depth=None):
        """Undistorted pixels [..., 2] -> unit-depth rays (or scaled by depth)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        if depth is not None:
            ray = ray * depth[..., None]
        return ray

    def distort_normalized(self, xy):
        """Apply radtan to normalized coords [..., 2]."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def undistort_pixels(self, uv, iters: int = 8):
        """Distorted pixels -> undistorted pixels (fixed-point iteration)."""
        xd = torch.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy], dim=-1)
        x = xd
        for _ in range(iters):
            d = self.distort_normalized(x) - x
            # the fixed point diverges far outside the model's domain
            x = torch.clamp(xd - d, -8.0, 8.0)
        return torch.stack([x[..., 0] * self.fx + self.cx, x[..., 1] * self.fy + self.cy],
                           dim=-1)

    def compute_bounds(self, width: int, height: int):
        """Undistort the 4 image corners (reference Frame::ComputeImageBounds)."""
        corners = torch.tensor([[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
                               dtype=torch.float32, device=self.device)
        und = self.undistort_pixels(corners)
        return torch.stack([
            torch.minimum(und[0, 0], und[2, 0]), torch.maximum(und[1, 0], und[3, 0]),
            torch.minimum(und[0, 1], und[1, 1]), torch.maximum(und[2, 1], und[3, 1]),
        ])

    def in_bounds(self, uv):
        b = self.bounds
        return ((uv[..., 0] >= b[0]) & (uv[..., 0] < b[1])
                & (uv[..., 1] >= b[2]) & (uv[..., 1] < b[3]))
