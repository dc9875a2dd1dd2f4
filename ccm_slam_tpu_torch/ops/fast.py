"""FAST-9/16 corner detection as dense tensor ops (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/fast.py``: the whole level is evaluated at
both thresholds in one pass and the reference's per-30px-cell threshold
fallback (``ORBextractor::ComputeKeyPointsOctTree``) is a per-cell mask:

    keypoint valid  <=>  corner@iniTh  OR  (corner@minTh AND cell has no corner@iniTh)

The ring samples use ``torch.roll`` with the reference's wrap-around; the
3 px border where the ring wraps is killed afterwards.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3 (dy, dx), the standard FAST-16 ring, in ring order.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9: at least 9 contiguous ring pixels


def _ring_shifts(img):
    """[16, H, W]: ring pixel value at offset k for every centre."""
    return torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in CIRCLE])


def _has_arc(mask):
    """[16,H,W] bool -> [H,W]: a wrap-around run of >= ARC_LEN set ring bits.

    The 16 bits are packed into one integer (plus the first ARC_LEN-1 bits
    again above bit 15 for the wrap), and a run starting at bit s is the AND
    of the word shifted by 0..ARC_LEN-1 -- the reference's OR over the 16
    start positions of ``all(ext[s:s+9])``."""
    weights = (1 << torch.arange(16, device=mask.device, dtype=torch.int64))[:, None, None]
    m = torch.sum(mask.to(torch.int64) * weights, dim=0)
    m = m | (m << 16)
    run = m
    for k in range(1, ARC_LEN):
        run = run & (m >> k)
    return (run & 0xFFFF) != 0


def fast_response(img, threshold: float):
    """(is_corner [H,W] bool, score [H,W] float32).

    Score = sum of |ring - centre| - threshold over ring pixels beyond the
    threshold, max of the bright and dark sums (cv::FAST's SAD score)."""
    img = img.to(torch.float32)
    ring = _ring_shifts(img)
    center = img[None]
    brighter = ring > center + threshold
    darker = ring < center - threshold
    corner = _has_arc(brighter) | _has_arc(darker)
    diff = torch.abs(ring - center) - threshold
    score_b = torch.sum(torch.where(brighter, diff, 0.0), dim=0)
    score_d = torch.sum(torch.where(darker, diff, 0.0), dim=0)
    score = torch.maximum(score_b, score_d)

    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    keep = corner & interior
    return keep, torch.where(keep, score, 0.0)


# the 8 neighbours in row-major order; the 4 lexicographically earlier ones
# need a strictly larger centre (ties go to the top-left pixel)
_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
_EARLIER = ((-1, -1), (-1, 0), (-1, 1), (0, -1))


def nms3x3(score):
    """3x3 non-maximum suppression; ties broken toward the top-left pixel."""
    keep = score > 0
    for dy, dx in _NEIGHBOURS:
        n = torch.roll(score, (-dy, -dx), dims=(0, 1))
        keep = keep & ((score > n) if (dy, dx) in _EARLIER else (score >= n))
    return keep


def cell_fallback_mask(corner_hi, corner_lo, cell: int = 30):
    """The reference's threshold fallback per ``cell``-px grid cell."""
    H, W = corner_hi.shape
    ph, pw = (-H) % cell, (-W) % cell
    hi_p = torch.nn.functional.pad(corner_hi, (0, pw, 0, ph))
    gh, gw = hi_p.shape[0] // cell, hi_p.shape[1] // cell
    has_hi = torch.any(hi_p.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, -1),
                       dim=-1)
    has_hi_full = has_hi.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]
    return corner_hi | (corner_lo & ~has_hi_full)


def detect(img, ini_th: float = 20.0, min_th: float = 7.0, cell: int = 30):
    """Full FAST stage for one pyramid level: (valid [H,W] bool, score [H,W]
    float32) after threshold fallback and 3x3 NMS."""
    c_hi, _ = fast_response(img, ini_th)
    c_lo, s_lo = fast_response(img, min_th)
    valid = cell_fallback_mask(c_hi, c_lo, cell)
    score = torch.where(valid, s_lo, 0.0)  # the low-threshold score is defined for both
    keep = nms3x3(score) & valid
    return keep, torch.where(keep, score, 0.0)
