"""ORB feature extraction: pyramid + FAST + grid distribution + IC angle +
steered BRIEF (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/orb.py`` (``extract``):

* 8-level pyramid (scale 1.2), each level resized from level 0 with the
  reference's ``jax.image.resize(..., "bilinear")`` semantics -- an
  antialiasing triangle filter widened by the downscale -- as two products
  with per-axis weight matrices built the way ``scale_and_translate`` builds
  them (``F.interpolate`` is a different filter);
* FAST with the per-cell threshold fallback (``ops/fast.py``);
* grid-bucketed top-1 per cell, then the per-level budget by a top-k in
  cell space that keeps the lower index first on ties (``jax.lax.top_k``);
* IC angle over a radius-15 disc and steered BRIEF on the 7x7-Gaussian-
  blurred level, both by direct gathers.

The reference's patch path (54x54 patch gather, band-matrix blur, one-hot
MXU sampling; ``orb.py:127-202``) is a TPU layout artifact that its own test
proves equal to the direct samplers, so the port blurs each level once and
gathers directly.

Returns fixed-capacity per-frame features with validity masks; keypoint
coordinates are level-0 (full-resolution) pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import brief, fast
from .hamming import top_k_stable


@dataclass(frozen=True)
class FrameFeatures:
    """Fixed-capacity per-frame feature set (N slots)."""

    xy: torch.Tensor        # [N,2] (x, y) in level-0 pixels, raw (distorted)
    response: torch.Tensor  # [N]
    octave: torch.Tensor    # [N] int32
    angle: torch.Tensor     # [N] radians
    desc: torch.Tensor      # [N,32] uint8
    valid: torch.Tensor     # [N] bool

    @property
    def n(self):
        return torch.sum(self.valid.to(torch.int32))


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Per-level keypoint budgets (reference ORBextractor ctor :603-617)."""
    q = 1.0 / scale_factor
    first = n_features * (1 - q) / (1 - q**n_levels)
    budgets = []
    acc = 0
    for lvl in range(n_levels - 1):
        b = int(round(first * q**lvl))
        budgets.append(b)
        acc += b
    budgets.append(max(n_features - acc, 0))
    return budgets


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    shapes = []
    for lvl in range(n_levels):
        inv = scale_factor**lvl
        shapes.append((max(int(round(h / inv)), 32), max(int(round(w / inv)), 32)))
    return shapes


@lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of an antialiased linear resize:
    the arithmetic of ``jax.image.scale_and_translate``'s
    ``compute_weight_mat`` (triangle kernel, widened by 1/scale when
    downscaling, columns normalised, samples outside the input zeroed), in
    float32 as the compiled reference computes it: the sample position as a
    fused multiply-add (emulated exactly in float64), divisions as products
    with the reciprocal.  A sample position one ulp off moves a weight by up
    to 1e-5 at 752 px; this arithmetic agrees with the reference's weights
    to 2 ulp."""
    f32, f64 = np.float32, np.float64
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    pos = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_f = (pos.astype(f64) * f64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist * (f32(1.0) / kernel_scale)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w * (f32(1.0) / np.where(total != 0, total, f32(1.0))), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img, shape):
    """``jax.image.resize(img, shape, "bilinear")`` for a 2-D float32 image."""
    H, W = img.shape
    h, w = shape
    out = img
    if h != H:
        out = torch.as_tensor(resize_weights(H, h), device=img.device).T @ out
    if w != W:
        out = out @ torch.as_tensor(resize_weights(W, w), device=img.device)
    return out


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    """Separable Gaussian blur with edge padding (the 7x7 blur before BRIEF,
    ORBextractor.cpp:1250), as sums of shifted slices."""
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    H, W = img.shape
    n = 2 * radius + 1
    p = torch.nn.functional.pad(img[None, None], (radius, radius, radius, radius),
                                mode="replicate")[0, 0]
    rows = sum(float(k[j]) * p[:, j:j + W] for j in range(n))      # along W
    return sum(float(k[j]) * rows[j:j + H, :] for j in range(n))   # along H


_CIRCLE_R = 15


def _circle_offsets():
    dy, dx = np.mgrid[-_CIRCLE_R:_CIRCLE_R + 1, -_CIRCLE_R:_CIRCLE_R + 1]
    mask = dx * dx + dy * dy <= _CIRCLE_R * _CIRCLE_R
    return dy[mask], dx[mask]


_IC_DY, _IC_DX = _circle_offsets()


def ic_angle(img, kp_xy):
    """Intensity-centroid orientation (radians) for keypoints [K,2] (x,y)."""
    H, W = img.shape
    dy = torch.as_tensor(_IC_DY, device=img.device)[None, :]
    dx = torch.as_tensor(_IC_DX, device=img.device)[None, :]
    x = torch.clamp(torch.round(kp_xy[:, 0:1]).to(torch.int64) + dx, 0, W - 1)
    y = torch.clamp(torch.round(kp_xy[:, 1:2]).to(torch.int64) + dy, 0, H - 1)
    vals = img[y, x]
    m10 = torch.sum(vals * dx.to(torch.float32), dim=1)
    m01 = torch.sum(vals * dy.to(torch.float32), dim=1)
    return torch.atan2(m01, m10)


def _extract_level(img_lvl, budget: int, ini_th, min_th, cell: int):
    """One pyramid level -> (xy [B,2], resp [B], angle [B], desc [B,32], valid [B])."""
    H, W = img_lvl.shape
    _, score = fast.detect(img_lvl, ini_th, min_th, cell)

    # grid-bucketed top-1 (~1.5x budget cells, aspect-proportional); the
    # top-k runs over the cells' winners
    n_cells = max(int(budget * 1.5), 4)
    gw = max(int(np.sqrt(n_cells * W / max(H, 1))), 1)
    gh = max(n_cells // max(gw, 1), 1)
    if budget > gh * gw:
        raise ValueError(f"level budget {budget} exceeds its {gh * gw} cells")
    ch, cw = -(-H // gh), -(-W // gw)
    s = torch.nn.functional.pad(score, (0, cw * gw - W, 0, ch * gh - H))
    cells = s.reshape(gh, ch, gw, cw).permute(0, 2, 1, 3).reshape(gh * gw, ch * cw)
    best = torch.amax(cells, dim=-1)
    best_off = torch.argmax(cells, dim=-1)  # first maximum, as jnp.argmax
    top_scores, top_cell = top_k_stable(best, budget)
    off = best_off[top_cell]
    ys = ((top_cell // gw) * ch + off // cw).to(torch.float32)
    xs = ((top_cell % gw) * cw + off % cw).to(torch.float32)
    xy = torch.stack([xs, ys], dim=-1)
    angle = ic_angle(img_lvl, xy)
    desc = brief.descriptor_bits(gaussian_blur(img_lvl), xy, angle)
    return xy, top_scores, angle, desc, top_scores > 0.0


def extract(
    img,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    cell: int = 30,
    capacity: int = 1024,
) -> FrameFeatures:
    """ORB features of a grayscale image [H, W] (float32 0..255), on the
    image's device."""
    img = img.to(torch.float32)
    H, W = img.shape
    shapes = level_shapes(H, W, n_levels, scale_factor)
    budgets = level_budgets(n_features, n_levels, scale_factor)
    total = sum(budgets)
    if capacity < total:
        raise ValueError(f"capacity {capacity} < total budget {total}")

    xs, rs, os_, angs, ds, vs = [], [], [], [], [], []
    for lvl in range(n_levels):
        img_lvl = img if lvl == 0 else resize_bilinear(img, shapes[lvl])
        xy, resp, ang, desc, val = _extract_level(img_lvl, budgets[lvl], ini_th, min_th, cell)
        xs.append(xy * scale_factor**lvl)
        rs.append(resp)
        os_.append(torch.full((budgets[lvl],), lvl, dtype=torch.int32, device=img.device))
        angs.append(ang)
        ds.append(desc)
        vs.append(val)

    pad = capacity - total
    F = torch.nn.functional
    return FrameFeatures(
        xy=F.pad(torch.cat(xs), (0, 0, 0, pad)),
        response=F.pad(torch.cat(rs), (0, pad)),
        octave=F.pad(torch.cat(os_), (0, pad)),
        angle=F.pad(torch.cat(angs), (0, pad)),
        desc=F.pad(torch.cat(ds), (0, 0, 0, pad)),
        valid=F.pad(torch.cat(vs), (0, pad)),
    )
