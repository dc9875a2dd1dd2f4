"""The rendered corridor: textured world, ground-truth trajectory and a
per-frame raycaster on the card, frozen here so that the benchmark's images
do not move when the program's own renderer does.

A copy of the program's ``io/rendered.py`` (corridor world, corridor
trajectory, radtan pixel rays, the torch raycaster and the sensor model)
with two changes: the world's textures are seeded through
``numpy.random.SeedSequence``, which takes any whole number, and the
sensor noise is drawn on the device from the run's seed after the frame
before noise has been rounded to 8 bits, so that every seed sees one world
(rendered once and cached as uint8 ``.npy`` files under
``cache_dir/<key>/``) through its own noise: the same work, other inputs.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

TEXTURE_VERSION = 2  # the program's texture generation version (part of the key)


def _rng(*key) -> np.random.RandomState:
    """A RandomState seeded from any whole numbers."""
    return np.random.RandomState(np.random.SeedSequence(list(key)).generate_state(4))


def _box_blur(img, k):
    if k <= 1:
        return img
    pad = k // 2
    out = np.pad(img, ((pad, pad), (pad, pad)), mode="reflect")
    c = np.vstack([np.zeros((1, out.shape[1]), out.dtype), np.cumsum(out, axis=0)])
    out = (c[k:] - c[:-k]) / k
    c = np.hstack([np.zeros((out.shape[0], 1), out.dtype), np.cumsum(out, axis=1)])
    out = (c[:, k:] - c[:, :-k]) / k
    return out[: img.shape[0], : img.shape[1]]


def make_texture(rng, h, w):
    """[h,w] float32 0..255: smooth base noise plus high-contrast rectangles
    (2 px up to a quarter of the extent) and discs."""
    base = rng.uniform(70, 150, (max(h // 32, 2), max(w // 32, 2))).astype(np.float32)
    base = np.kron(base, np.ones((32, 32), np.float32))[:h, :w]
    if base.shape != (h, w):
        base = np.pad(base, ((0, h - base.shape[0]), (0, w - base.shape[1])), mode="edge")
    tex = _box_blur(base, 17)

    def splat_rects(n_rect, smin, smax, vmin, vmax):
        ys, xs = rng.randint(0, h, n_rect), rng.randint(0, w, n_rect)
        sy, sx = rng.randint(smin, smax, n_rect), rng.randint(smin, smax, n_rect)
        dv = rng.uniform(-vmax, vmax, n_rect)
        dv = np.sign(dv) * np.maximum(np.abs(dv), vmin)
        for i in range(n_rect):
            tex[ys[i]:min(h, ys[i] + sy[i]), xs[i]:min(w, xs[i] + sx[i])] += dv[i]

    splat_rects(max(20, (h * w) // 1800), 6, max(8, min(h, w) // 4), 35, 90)
    splat_rects(max(40, (h * w) // 350), 2, 12, 25, 60)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(max(4, (h * w) // 21600)):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(8, max(10, min(h, w) // 5))
        dvv = rng.uniform(35, 80) * rng.choice([-1, 1])
        tex[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += dvv
    return np.clip(tex, 15, 240).astype(np.float32)


def _plane(rng, p0, e1, e2, texel_per_m=48.0):
    p0, e1, e2 = (np.asarray(v, np.float32) for v in (p0, e1, e2))
    tw = max(int(np.linalg.norm(e1) * texel_per_m), 32)
    th = max(int(np.linalg.norm(e2) * texel_per_m), 32)
    n = np.cross(e1, e2)
    return dict(p0=p0, e1=e1, e2=e2, normal=n / np.linalg.norm(n), tex=make_texture(rng, th, tw))


def corridor_world(seed):
    """Straight corridor along +x: walls at y=+-2.2, floor z=-1.4, ceiling
    z=+2.0, end wall."""
    rng = _rng(seed, 0)
    L0, L1 = -8.0, 100.0
    return [
        _plane(rng, [L0, -2.2, -1.4], [L1 - L0, 0, 0], [0, 0, 3.4]),
        _plane(rng, [L0, 2.2, -1.4], [L1 - L0, 0, 0], [0, 0, 3.4]),
        _plane(rng, [L0, -2.2, -1.4], [L1 - L0, 0, 0], [0, 4.4, 0]),
        _plane(rng, [L0, -2.2, 2.0], [L1 - L0, 0, 0], [0, 4.4, 0]),
        _plane(rng, [L1, -2.2, -1.4], [0, 4.4, 0], [0, 0, 3.4]),
    ]


def _yaw_R_wc(yaw, pitch=0.0):
    f = np.array([math.cos(yaw) * math.cos(pitch), math.sin(yaw) * math.cos(pitch),
                  math.sin(pitch)], np.float32)
    r = np.cross(f, np.array([0.0, 0.0, 1.0], np.float32))
    r /= np.linalg.norm(r)
    return np.stack([r, np.cross(f, r), f], axis=1)


def corridor_trajectory(n_frames, fps, span):
    """[(t, centre [3], R_wc [3,3])]: a forward walk along the corridor with
    lateral sway, height bob and yaw wobble."""
    out = []
    s0, s1 = span
    for i in range(n_frames):
        t = i / fps
        x = 88.0 * (s0 + (s1 - s0) * (i / max(n_frames - 1, 1)))
        o = np.array([x, 0.8 * math.sin(0.28 * x), 0.18 * math.sin(1.3 * t)], np.float32)
        yaw = 0.14 * math.sin(0.30 * x) + 0.05 * math.sin(1.7 * t)
        out.append((t, o, _yaw_R_wc(yaw, 0.05 * math.sin(0.9 * t))))
    return out


def pixel_rays(cam, ss):
    """[H*ss, W*ss, 3] unit camera-frame rays of the distorted pixel grid
    (radtan inverted by fixed-point iteration)."""
    H, W = cam["height"] * ss, cam["width"] * ss
    u, v = np.meshgrid((np.arange(W, dtype=np.float64) + 0.5) / ss - 0.5,
                       (np.arange(H, dtype=np.float64) + 0.5) / ss - 0.5)
    xd, yd = (u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"]
    x, y = xd.copy(), yd.copy()
    k1, k2, p1, p2 = cam["k1"], cam["k2"], cam["p1"], cam["p2"]
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        x = (xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / radial
        y = (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / radial
    d = np.stack([x, y, np.ones_like(x)], axis=-1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def make_raycaster(planes, rays_cam, ss, dev):
    """``run(R_wc, o_w) -> [H, W]`` float32 on ``dev``: closest positive hit,
    bilinear texture sample, box integration over the ss x ss subgrid."""
    H, W, _ = rays_cam.shape
    rays = torch.as_tensor(rays_cam.reshape(-1, 3), device=dev)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    geo = [(t(p["p0"]), t(p["e1"]), t(p["e2"]), t(p["normal"]), float(np.dot(p["e1"], p["e1"])),
            float(np.dot(p["e2"], p["e2"])), t(p["tex"])) for p in planes]

    def run(R_wc, o_w):
        R, o = t(R_wc), t(o_w)
        d = rays @ R.T
        best_tt = torch.full((rays.shape[0],), float("inf"), device=dev)
        best_val = torch.full((rays.shape[0],), 25.0, device=dev)
        for p0, e1, e2, n, e1sq, e2sq, tex in geo:
            denom = d @ n
            tt = torch.dot(p0 - o, n) / denom
            rel = o - p0
            a = (torch.dot(rel, e1) + tt * (d @ e1)) / e1sq
            b = (torch.dot(rel, e2) + tt * (d @ e2)) / e2sq
            ok = ((torch.abs(denom) > 1e-9) & (tt > 0.05) & (tt < best_tt)
                  & (a >= 0) & (a < 1) & (b >= 0) & (b < 1))
            th, tw = tex.shape
            fu = torch.nan_to_num(torch.clamp(a, 0.0, 1.0)) * (tw - 1)
            fv = torch.nan_to_num(torch.clamp(b, 0.0, 1.0)) * (th - 1)
            u0, v0 = fu.to(torch.int64), fv.to(torch.int64)
            u1, v1 = torch.clamp(u0 + 1, max=tw - 1), torch.clamp(v0 + 1, max=th - 1)
            au, av = fu - u0, fv - v0
            val = (tex[v0, u0] * (1 - au) * (1 - av) + tex[v0, u1] * au * (1 - av)
                   + tex[v1, u0] * (1 - au) * av + tex[v1, u1] * au * av)
            best_val = torch.where(ok, val, best_val)
            best_tt = torch.where(ok, tt, best_tt)
        img = best_val.reshape(H, W)
        if ss > 1:
            img = img.reshape(H // ss, ss, W // ss, ss).mean(dim=(1, 3))
        return img

    return run


def exposure(img, t):
    """Exposure drift and vignetting of a device frame, rounded to 8 bits."""
    H, W = img.shape
    gain = 1.0 + 0.10 * math.sin(0.45 * t + 0.7)
    yy = (np.arange(H, dtype=np.float32) - H / 2) / (H / 2)
    xx = (np.arange(W, dtype=np.float32) - W / 2) / (W / 2)
    vign = 1.0 - 0.25 * (yy[:, None] ** 2 + xx[None, :] ** 2) / 2.0
    img = img * gain * torch.as_tensor(vign, device=img.device)
    return torch.clamp(img + 0.5, 0, 255).to(torch.uint8)


class Corridor:
    """``n_frames`` frames of the corridor of ``world_seed`` over ``span`` of
    its length.  ``base(i)`` is frame i before sensor noise, a uint8 [H, W]
    tensor on ``dev`` (rendered, or read from ``cache_dir``); ``frames(seed)``
    are all frames with the sensor noise of ``seed`` (Gaussian, ``noise_std``
    grey levels, drawn on the device) added and quantized to 8 bits."""

    def __init__(self, world_seed, n_frames, span, cam, dev, cache_dir=None, supersample=2,
                 noise_std=2.0):
        self.world_seed, self.n_frames, self.span, self.cam = world_seed, n_frames, tuple(span), cam
        self.dev, self.ss, self.noise_std = dev, supersample, noise_std
        self.traj = corridor_trajectory(n_frames, cam["fps"], self.span)
        self.dir = None
        if cache_dir is not None:
            key = (f"corridor-w{world_seed}-n{n_frames}-sp{self.span[0]:g}-{self.span[1]:g}-ss"
                   f"{supersample}-w{cam['width']}x{cam['height']}-tv{TEXTURE_VERSION}")
            self.dir = os.path.join(cache_dir, key)
            os.makedirs(self.dir, exist_ok=True)
        self._raycast = None

    def base(self, i):
        path = None if self.dir is None else os.path.join(self.dir, f"{i:05d}.npy")
        if path is not None and os.path.exists(path):
            return torch.as_tensor(np.load(path), device=self.dev)
        if self._raycast is None:
            self._raycast = make_raycaster(corridor_world(self.world_seed),
                                           pixel_rays(self.cam, self.ss), self.ss, self.dev)
        t, o, R_wc = self.traj[i]
        img = exposure(self._raycast(R_wc, o), t)
        if path is not None:
            tmp = f"{path}.{os.getpid()}.tmp.npy"
            np.save(tmp, img.cpu().numpy())
            os.replace(tmp, path)
        return img

    def frames(self, seed):
        bases = torch.stack([self.base(i) for i in range(self.n_frames)])
        g = torch.Generator(device=self.dev).manual_seed(seed)
        noise = torch.randn(bases.shape, generator=g, device=self.dev) * self.noise_std
        return list(torch.clamp(bases.to(torch.float32) + noise, 0, 255).to(torch.uint8))

    def centres(self):
        """[n_frames, 3] ground-truth camera centres."""
        return np.stack([o for _, o, _ in self.traj]).astype(np.float64)
