"""Steered-BRIEF sampling pattern and descriptor bits (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/brief.py``: the framework's own seeded
Gaussian 256-pair pattern (the original BRIEF recipe, pairs ~ N(0,
(patch/5)^2)), generated by the same numpy call so both packages hold the
same pattern; descriptors only need to agree within the framework.
"""

from __future__ import annotations

import numpy as np
import torch

from .hamming import pack_bits

PATCH_HALF = 15  # sample coordinates stay inside the 31x31 patch
N_BITS = 256


def make_pattern(seed: int = 20260817) -> np.ndarray:
    """[256, 4] int8 array of (x1, y1, x2, y2) sample offsets."""
    rng = np.random.RandomState(seed)
    sigma = (2 * PATCH_HALF + 1) / 5.0
    pts = rng.randn(N_BITS, 4) * sigma
    pts = np.clip(np.round(pts), -(PATCH_HALF - 2), PATCH_HALF - 2)
    return pts.astype(np.int8)


PATTERN = make_pattern()


def steered_coords(angle_rad):
    """Rotate the pattern by per-keypoint angles.

    angle_rad [K] -> (p1 [K,256,2], p2 [K,256,2]) float32 (x, y) offsets."""
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=angle_rad.device)
    ca = torch.cos(angle_rad)[:, None]
    sa = torch.sin(angle_rad)[:, None]
    x1, y1, x2, y2 = (pat[:, i][None] for i in range(4))
    r1 = torch.stack([x1 * ca - y1 * sa, x1 * sa + y1 * ca], dim=-1)
    r2 = torch.stack([x2 * ca - y2 * sa, x2 * sa + y2 * ca], dim=-1)
    return r1, r2


def descriptor_bits(img, kp_xy, angle_rad):
    """Steered-BRIEF bits by nearest-neighbour lookups.

    img [H, W] (pre-blurred); kp_xy [K, 2] (x, y); angle_rad [K].
    Returns uint8 [K, 32]."""
    H, W = img.shape
    p1, p2 = steered_coords(angle_rad)
    base = kp_xy[:, None, :]

    def sample(p):
        x = torch.clamp(torch.round(base[..., 0] + p[..., 0]).to(torch.int64), 0, W - 1)
        y = torch.clamp(torch.round(base[..., 1] + p[..., 1]).to(torch.int64), 0, H - 1)
        return img[y, x]

    return pack_bits((sample(p1) < sample(p2)).to(torch.uint8))
