"""Plain ORB extraction: the semantics of the program's ``orb.extract``.

Pyramid levels resized from level 0 by an antialiased triangle filter
(``jax.image.scale_and_translate``'s weights, as two products with per-axis
weight matrices), FAST-9 on a radius-3 ring at the initial and the minimum
threshold with the per-cell fallback, 3x3 non-maximum suppression with ties
to the top-left pixel, the best corner of each grid cell and the level's
budget of cells by score (the lower cell first among equals), the intensity
centroid over a radius-15 disc, and steered BRIEF (the seeded Gaussian
256-pair pattern) on the level blurred by a 7x7 Gaussian of sigma 2.

Floating sums are formed in the program's order (a sum over a stacked axis,
sums of shifted slices in offset order), so that the two agree to the bit
on one device; the comparison then has the limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
ARC = 9
PATTERN_SEED = 20260817


def budgets(n_features, n_levels, scale):
    q = 1.0 / scale
    first = n_features * (1 - q) / (1 - q ** n_levels)
    out = [int(round(first * q ** lvl)) for lvl in range(n_levels - 1)]
    return out + [max(n_features - sum(out), 0)]


def shapes(h, w, n_levels, scale):
    return [(max(int(round(h / scale ** lvl)), 32), max(int(round(w / scale ** lvl)), 32))
            for lvl in range(n_levels)]


def resize_matrix(n_in, n_out):
    """[n_in, n_out] float32 triangle-filter weights (float32 arithmetic,
    the sample position rounded once from float64)."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    ks = max(inv, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64) * np.float64(inv)
              - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist * (f32(1.0) / ks)).astype(f32)
    tot = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(f32).eps),
                 w * (f32(1.0) / np.where(tot != 0, tot, f32(1.0))), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(img, shape):
    H, W = img.shape
    h, w = shape
    out = img
    if h != H:
        out = torch.as_tensor(resize_matrix(H, h), device=img.device).T @ out
    if w != W:
        out = out @ torch.as_tensor(resize_matrix(W, w), device=img.device)
    return out


def _arc(mask):
    """[16,H,W] bool -> [H,W]: some ARC consecutive ring samples (cyclic)."""
    bits = torch.sum(mask.to(torch.int64)
                     * (1 << torch.arange(16, device=mask.device))[:, None, None], 0)
    bits = bits | (bits << 16)
    run = bits
    for k in range(1, ARC):
        run = run & (bits >> k)
    return (run & 0xFFFF) != 0


def _fast(img, th):
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in RING])
    c = img[None]
    hi, lo = ring > c + th, ring < c - th
    corner = _arc(hi) | _arc(lo)
    d = torch.abs(ring - c) - th
    score = torch.maximum(torch.sum(torch.where(hi, d, 0.0), 0),
                          torch.sum(torch.where(lo, d, 0.0), 0))
    H, W = img.shape
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    keep = corner & (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return keep, torch.where(keep, score, 0.0)


def _detect(img, ini_th, min_th, cell):
    c_hi, _ = _fast(img, ini_th)
    c_lo, s_lo = _fast(img, min_th)
    H, W = img.shape
    hp = torch.nn.functional.pad(c_hi, (0, (-W) % cell, 0, (-H) % cell))
    gh, gw = hp.shape[0] // cell, hp.shape[1] // cell
    any_hi = hp.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, -1).any(-1)
    any_hi = any_hi.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]
    valid = c_hi | (c_lo & ~any_hi)
    score = torch.where(valid, s_lo, 0.0)
    keep = score > 0
    for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)):
        n = torch.roll(score, (-dy, -dx), dims=(0, 1))
        keep = keep & ((score > n) if (dy, dx) < (0, 0) else (score >= n))
    keep = keep & valid
    return torch.where(keep, score, 0.0)


def _blur(img, sigma=2.0, radius=3):
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    H, W = img.shape
    p = torch.nn.functional.pad(img[None, None], (radius,) * 4, mode="replicate")[0, 0]
    rows = sum(float(k[j]) * p[:, j:j + W] for j in range(2 * radius + 1))
    return sum(float(k[j]) * rows[j:j + H, :] for j in range(2 * radius + 1))


def _disc(r=15):
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    inside = dx * dx + dy * dy <= r * r
    return dy[inside], dx[inside]


def _pattern():
    rng = np.random.RandomState(PATTERN_SEED)
    pts = np.clip(np.round(rng.randn(256, 4) * (31 / 5.0)), -13, 13)
    return pts.astype(np.int8)


def _level(img, budget, ini_th, min_th, cell):
    H, W = img.shape
    score = _detect(img, ini_th, min_th, cell)
    n_cells = max(int(budget * 1.5), 4)
    gw = max(int(np.sqrt(n_cells * W / max(H, 1))), 1)
    gh = max(n_cells // gw, 1)
    ch, cw = -(-H // gh), -(-W // gw)
    s = torch.nn.functional.pad(score, (0, cw * gw - W, 0, ch * gh - H))
    cells = s.reshape(gh, ch, gw, cw).permute(0, 2, 1, 3).reshape(gh * gw, ch * cw)
    best, best_off = torch.amax(cells, -1), torch.argmax(cells, -1)
    order = torch.sort(best, descending=True, stable=True).indices[:budget]
    top = best[order]
    off = best_off[order]
    xy = torch.stack([((order % gw) * cw + off % cw).to(torch.float32),
                      ((order // gw) * ch + off // cw).to(torch.float32)], -1)
    # intensity centroid
    dy, dx = (torch.as_tensor(a, device=img.device)[None, :] for a in _disc())
    xi = torch.clamp(torch.round(xy[:, 0:1]).to(torch.int64) + dx, 0, W - 1)
    yi = torch.clamp(torch.round(xy[:, 1:2]).to(torch.int64) + dy, 0, H - 1)
    vals = img[yi, xi]
    angle = torch.atan2(torch.sum(vals * dy.to(torch.float32), 1),
                        torch.sum(vals * dx.to(torch.float32), 1))
    # steered BRIEF on the blurred level
    blur = _blur(img)
    pat = torch.as_tensor(_pattern(), dtype=torch.float32, device=img.device)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    def sample(px, py):
        rx, ry = px[None] * ca - py[None] * sa, px[None] * sa + py[None] * ca
        x = torch.clamp(torch.round(xy[:, None, 0] + rx).to(torch.int64), 0, W - 1)
        y = torch.clamp(torch.round(xy[:, None, 1] + ry).to(torch.int64), 0, H - 1)
        return blur[y, x]

    bits = (sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])).to(torch.uint8)
    b = bits.reshape(-1, 32, 8)
    desc = torch.sum(b << torch.arange(8, dtype=torch.uint8, device=img.device), -1)
    return xy, angle, desc.to(torch.uint8), top > 0.0


def extract(img, n_features, n_levels, scale, ini_th, min_th, cell, capacity):
    """dict(xy [N,2] level-0 pixels, octave [N], angle [N], desc [N,32],
    valid [N]) in ``capacity`` slots, levels in order, padding at the end."""
    img = img.to(torch.float32)
    H, W = img.shape
    bud = budgets(n_features, n_levels, scale)
    xs, os_, angs, ds, vs = [], [], [], [], []
    for lvl, shape in enumerate(shapes(H, W, n_levels, scale)):
        im = img if lvl == 0 else resize(img, shape)
        xy, ang, desc, val = _level(im, bud[lvl], float(ini_th), float(min_th), cell)
        xs.append(xy * scale ** lvl)
        os_.append(torch.full((bud[lvl],), lvl, dtype=torch.int32, device=img.device))
        angs.append(ang)
        ds.append(desc)
        vs.append(val)
    pad = capacity - sum(bud)
    F = torch.nn.functional
    return dict(xy=F.pad(torch.cat(xs), (0, 0, 0, pad)), octave=F.pad(torch.cat(os_), (0, pad)),
                angle=F.pad(torch.cat(angs), (0, pad)), desc=F.pad(torch.cat(ds), (0, 0, 0, pad)),
                valid=F.pad(torch.cat(vs), (0, pad)))


def mismatched_slots(prog, ref):
    """Feature slots where the program's and the reference's validity,
    keypoint, octave or descriptor differ (valid slots of either side)."""
    same = ((prog["valid"] == ref["valid"]) & torch.all(prog["xy"] == ref["xy"], -1)
            & (prog["octave"] == ref["octave"]) & torch.all(prog["desc"] == ref["desc"], -1))
    either = prog["valid"] | ref["valid"]
    return int(torch.sum(either & ~same)), int(torch.sum(either))
