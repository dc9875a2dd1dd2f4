"""Photometrically realistic rendered sequences with exact ground truth
(numpy; the port's own copy of ``ccm_slam_tpu/io/rendered.py``).

752x480 @ 20 fps grayscale frames rendered from textured 3-D worlds through
the EuRoC camera model (intrinsics + radial-tangential distortion), with
per-frame exposure drift, vignetting and sensor noise, and exact ground
truth -- the worlds the JAX package's rendered accuracy gates use:

* ``corridor`` -- a straight ~95 m textured corridor;
* ``loop``     -- a rectangular corridor circuit that returns to its start.

Rendering: per-pixel rays are precomputed once by iteratively undistorting
the pixel grid; each frame intersects the rays with the world's planes and
bilinearly samples per-plane procedural textures.  Two backends:

* ``numpy`` (the default): the reference's numpy path; frames identical to
  the reference's for the same seed and camera;
* ``torch``: the counterpart of the reference's XLA raycaster
  (``make_raycaster_jax``) in plain tensor work on a device (the card unless
  told otherwise); frames come back as float32 tensors on that device.  The
  sensor noise is drawn from the same numpy stream, so frames differ from
  the numpy path only by float rounding of the ray geometry.

``cache_dir`` keeps each rendered frame on disk as a uint8 ``.npy`` under
the reference's key and file layout (``_cache_path``), so both packages can
share one cache directory and reruns skip the rendering.  As in the
reference, a frame read back from the cache is the uint8 image as float32;
the render that filled it returned the unquantized frame.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import CameraConfig
from ..device import resolve_device
from .euroc import EurocFrame

# --------------------------------------------------------------- textures ----

# the reference's texture generation version, part of the frame cache's key
# (bump when the procedural textures change: the key cannot hash them)
TEXTURE_VERSION = 2


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Separable box blur via cumulative sums (no scipy)."""
    if k <= 1:
        return img
    pad = k // 2
    out = np.pad(img, ((pad, pad), (pad, pad)), mode="reflect")
    c = np.vstack([np.zeros((1, out.shape[1]), out.dtype), np.cumsum(out, axis=0)])
    out = (c[k:] - c[:-k]) / k
    c = np.hstack([np.zeros((out.shape[0], 1), out.dtype), np.cumsum(out, axis=1)])
    out = (c[:, k:] - c[:, :-k]) / k
    return out[: img.shape[0], : img.shape[1]]


def make_texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """[h,w] float32 grayscale 0..255 with corners at MANY scales: smooth
    base noise + high-contrast rectangles/discs from 2 px up to 1/4 extent.

    The fine (2-12 px) generation matters most: surfaces closest to the
    camera are magnified the most and carry the strongest parallax, so they
    must still show detectable corners — a texture whose smallest feature is
    ~8 px turns into featureless flats (floor/ceiling) or one-directional
    streaks (grazing walls) exactly where tracking needs anchors."""
    base = rng.uniform(70, 150, (max(h // 32, 2), max(w // 32, 2))).astype(np.float32)
    base = np.kron(base, np.ones((32, 32), np.float32))[:h, :w]
    if base.shape != (h, w):
        base = np.pad(base, ((0, h - base.shape[0]), (0, w - base.shape[1])), mode="edge")
    base = _box_blur(base, 17)
    tex = base

    def splat_rects(n_rect, smin, smax, vmin, vmax):
        ys = rng.randint(0, h, n_rect)
        xs = rng.randint(0, w, n_rect)
        sy = rng.randint(smin, smax, n_rect)
        sx = rng.randint(smin, smax, n_rect)
        dv = rng.uniform(-vmax, vmax, n_rect)
        dv = np.sign(dv) * np.maximum(np.abs(dv), vmin)  # never low-contrast
        for i in range(n_rect):
            y0, x0 = ys[i], xs[i]
            y1, x1 = min(h, y0 + sy[i]), min(w, x0 + sx[i])
            tex[y0:y1, x0:x1] += dv[i]

    # coarse rectangles: sizes span the pyramid's scale range
    splat_rects(max(20, (h * w) // 1800), 6, max(8, min(h, w) // 4), 35, 90)
    # fine rectangles: near-field detail (2-12 px; dense enough that a
    # close-up patch of a few hundred texels still has several corners)
    splat_rects(max(40, (h * w) // 350), 2, 12, 25, 60)
    # a few discs for non-axis-aligned gradients
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n_disc = max(4, (h * w) // 21600)
    for _ in range(n_disc):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(8, max(10, min(h, w) // 5))
        dvv = rng.uniform(35, 80) * rng.choice([-1, 1])
        m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        tex[m] += dvv
    return np.clip(tex, 15, 240).astype(np.float32)


# ------------------------------------------------------------------ planes ----


@dataclass
class Plane:
    p0: np.ndarray   # corner [3]
    e1: np.ndarray   # edge vector [3], texture u axis
    e2: np.ndarray   # edge vector [3], texture v axis
    tex: np.ndarray  # [Th,Tw] float32

    @property
    def normal(self):
        n = np.cross(self.e1, self.e2)
        return n / np.linalg.norm(n)


def _plane(rng, p0, e1, e2, texel_per_m: float = 48.0) -> Plane:
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    tw = max(int(np.linalg.norm(e1) * texel_per_m), 32)
    th = max(int(np.linalg.norm(e2) * texel_per_m), 32)
    return Plane(p0=p0, e1=e1, e2=e2, tex=make_texture(rng, th, tw))


def corridor_world(seed: int = 0):
    """Straight corridor along +x: walls at y=+-2.2, floor z=-1.4, ceiling
    z=+2.0, end wall.  ~95 m of track."""
    rng = np.random.RandomState(seed)
    L0, L1 = -8.0, 100.0
    planes = [
        _plane(rng, [L0, -2.2, -1.4], [L1 - L0, 0, 0], [0, 0, 3.4]),   # left wall
        _plane(rng, [L0, 2.2, -1.4], [L1 - L0, 0, 0], [0, 0, 3.4]),    # right wall
        _plane(rng, [L0, -2.2, -1.4], [L1 - L0, 0, 0], [0, 4.4, 0]),   # floor
        _plane(rng, [L0, -2.2, 2.0], [L1 - L0, 0, 0], [0, 4.4, 0]),    # ceiling
        _plane(rng, [L1, -2.2, -1.4], [0, 4.4, 0], [0, 0, 3.4]),       # end wall
    ]
    return planes


def loop_world(seed: int = 0, W: float = 36.0, H: float = 26.0, hw: float = 2.4):
    """Rectangular corridor circuit: outer box [0,W]x[0,H], inner box inset
    by the corridor width 2*hw.  The track runs between the boxes."""
    rng = np.random.RandomState(seed)
    zi, ze = -1.4, 2.0
    zh = ze - zi
    iw = 2 * hw  # corridor width
    x0, x1 = iw, W - iw
    y0, y1 = iw, H - iw
    planes = []
    # outer walls (facing inward)
    planes.append(_plane(rng, [0, 0, zi], [W, 0, 0], [0, 0, zh]))
    planes.append(_plane(rng, [0, H, zi], [W, 0, 0], [0, 0, zh]))
    planes.append(_plane(rng, [0, 0, zi], [0, H, 0], [0, 0, zh]))
    planes.append(_plane(rng, [W, 0, zi], [0, H, 0], [0, 0, zh]))
    # inner block walls (facing outward)
    planes.append(_plane(rng, [x0, y0, zi], [x1 - x0, 0, 0], [0, 0, zh]))
    planes.append(_plane(rng, [x0, y1, zi], [x1 - x0, 0, 0], [0, 0, zh]))
    planes.append(_plane(rng, [x0, y0, zi], [0, y1 - y0, 0], [0, 0, zh]))
    planes.append(_plane(rng, [x1, y0, zi], [0, y1 - y0, 0], [0, 0, zh]))
    # floor + ceiling
    planes.append(_plane(rng, [0, 0, zi], [W, 0, 0], [0, H, 0], texel_per_m=32.0))
    planes.append(_plane(rng, [0, 0, ze], [W, 0, 0], [0, H, 0], texel_per_m=32.0))
    return planes


# ------------------------------------------------------------ trajectories ----


def _yaw_R_wc(yaw: float, pitch: float = 0.0):
    """Camera-to-world rotation: camera forward (+z_cam) points along yaw in
    the world xy plane (world +z up); x_cam = right, y_cam = down."""
    f = np.array([math.cos(yaw) * math.cos(pitch),
                  math.sin(yaw) * math.cos(pitch),
                  math.sin(pitch)], np.float32)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)  # camera down
    R_wc = np.stack([r, d, f], axis=1)  # columns = cam axes in world
    return R_wc


def corridor_trajectory(n_frames: int, fps: float, span=(0.0, 1.0), seed: int = 0):
    """Forward walk 0 -> 88 m with gentle lateral sway, height bob and yaw
    wobble (EuRoC-like excitation so translation is never degenerate)."""
    ts = np.arange(n_frames) / fps
    out = []
    s0, s1 = span
    for i, t in enumerate(ts):
        s = s0 + (s1 - s0) * (i / max(n_frames - 1, 1))
        x = 88.0 * s
        y = 0.8 * math.sin(0.28 * x)
        z = 0.18 * math.sin(1.3 * t)
        yaw = 0.14 * math.sin(0.30 * x) + 0.05 * math.sin(1.7 * t)
        pitch = 0.05 * math.sin(0.9 * t)
        o = np.array([x, y, z], np.float32)
        out.append((t, o, _yaw_R_wc(yaw, pitch)))
    return out


def loop_trajectory(n_frames: int, fps: float, span=(0.0, 1.0), seed: int = 0,
                    W: float = 36.0, H: float = 26.0, hw: float = 2.4):
    """Circuit along the corridor centerline between the outer box and the
    inner block (the corridor spans 0..2*hw from each outer wall, so the
    centerline is offset hw); span in laps (1.04 revisits the start for
    loop closure)."""
    cx0, cx1 = hw, W - hw
    cy0, cy1 = hw, H - hw
    r = 1.6  # corner radius
    sx, sy = cx1 - cx0 - 2 * r, cy1 - cy0 - 2 * r
    arc = math.pi * r / 2
    seg = [sx, arc, sy, arc, sx, arc, sy, arc]
    total = sum(seg)
    cum = np.concatenate([[0], np.cumsum(seg)])

    def pose_at(d):
        d = d % total
        k = int(np.searchsorted(cum, d, side="right") - 1)
        u = d - cum[k]
        if k == 0:    # bottom edge, +x
            p = [cx0 + r + u, cy0, 0]; yaw = 0.0
        elif k == 1:  # corner
            a = u / r
            p = [cx1 - r + r * math.sin(a), cy0 + r - r * math.cos(a), 0]
            yaw = a
        elif k == 2:  # right edge, +y
            p = [cx1, cy0 + r + u, 0]; yaw = math.pi / 2
        elif k == 3:
            a = u / r
            p = [cx1 - r + r * math.cos(a), cy1 - r + r * math.sin(a), 0]
            yaw = math.pi / 2 + a
        elif k == 4:  # top edge, -x
            p = [cx1 - r - u, cy1, 0]; yaw = math.pi
        elif k == 5:
            a = u / r
            p = [cx0 + r - r * math.sin(a), cy1 - r + r * math.cos(a), 0]
            yaw = math.pi + a
        elif k == 6:  # left edge, -y
            p = [cx0, cy1 - r - u, 0]; yaw = 3 * math.pi / 2
        else:
            a = u / r
            p = [cx0 + r - r * math.cos(a), cy0 + r - r * math.sin(a), 0]
            yaw = 3 * math.pi / 2 + a
        return np.asarray(p, np.float32), yaw

    ts = np.arange(n_frames) / fps
    s0, s1 = span
    out = []
    for i, t in enumerate(ts):
        s = s0 + (s1 - s0) * (i / max(n_frames - 1, 1))
        p, yaw = pose_at(s * total)
        p = p + np.array([0.0, 0.0, 0.10 * math.sin(1.5 * t)], np.float32)
        pitch = 0.03 * math.sin(0.8 * t)
        out.append((t, p, _yaw_R_wc(yaw + 0.05 * math.sin(1.1 * t), pitch)))
    return out


# ---------------------------------------------------------------- renderer ----


def pixel_rays(cam: CameraConfig, ss: int = 1) -> np.ndarray:
    """[H*ss,W*ss,3] unit ray directions in the CAMERA frame for every
    (sub)pixel of the DISTORTED image: invert the radtan model by fixed-point
    iteration (the forward model matches utils/camera.py /
    cv::undistortPoints).  ``ss`` supersamples the pixel grid for rendering
    anti-aliasing (a real sensor integrates over the pixel area; point
    sampling aliases fine texture and scrambles FAST/BRIEF repeatability)."""
    H, W = cam.height * ss, cam.width * ss
    # index convention: the FAST detector reports keypoints at integer array
    # coordinates, so subpixel sample positions center on the index grid
    u, v = np.meshgrid((np.arange(W, dtype=np.float64) + 0.5) / ss - 0.5,
                       (np.arange(H, dtype=np.float64) + 0.5) / ss - 0.5)
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
        dx = 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
        dy = cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    d = np.stack([x, y, np.ones_like(x)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float32)


def render(planes, rays_cam: np.ndarray, R_wc: np.ndarray, o_w: np.ndarray,
           rng: np.random.RandomState, t: float = 0.0,
           noise_std: float = 2.0, exposure: bool = True,
           ss: int = 1) -> np.ndarray:
    """Raycast one [H,W] grayscale frame from camera center o_w with
    camera-to-world rotation R_wc.  ``ss``: rays_cam is an ss-x supersampled
    grid; the result is box-integrated down to the sensor resolution
    (pixel-area integration = anti-aliasing)."""
    H, W, _ = rays_cam.shape
    d = rays_cam.reshape(-1, 3) @ R_wc.T  # [N,3] world
    depth = np.full(H * W, np.inf, np.float32)
    img = np.full(H * W, 25.0, np.float32)
    for pl in planes:
        n = pl.normal
        denom = d @ n
        tnum = float(np.dot(pl.p0 - o_w, n))
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = tnum / denom
        ok = (np.abs(denom) > 1e-9) & (tt > 0.05) & (tt < depth)
        if not ok.any():
            continue
        hit = o_w + tt[ok, None] * d[ok]
        loc = hit - pl.p0
        a = (loc @ pl.e1) / float(np.dot(pl.e1, pl.e1))
        b = (loc @ pl.e2) / float(np.dot(pl.e2, pl.e2))
        inb = (a >= 0) & (a < 1) & (b >= 0) & (b < 1)
        if not inb.any():
            continue
        idx = np.where(ok)[0][inb]
        th, tw = pl.tex.shape
        fu = a[inb] * (tw - 1)
        fv = b[inb] * (th - 1)
        u0 = fu.astype(np.int32)
        v0 = fv.astype(np.int32)
        u1 = np.minimum(u0 + 1, tw - 1)
        v1 = np.minimum(v0 + 1, th - 1)
        au = (fu - u0).astype(np.float32)
        av = (fv - v0).astype(np.float32)
        val = (
            pl.tex[v0, u0] * (1 - au) * (1 - av)
            + pl.tex[v0, u1] * au * (1 - av)
            + pl.tex[v1, u0] * (1 - au) * av
            + pl.tex[v1, u1] * au * av
        )
        img[idx] = val
        depth[idx] = tt[ok][inb]
    img = img.reshape(H, W)
    if ss > 1:
        # sensor pixel integration: average the ss x ss subpixel samples
        img = img.reshape(H // ss, ss, W // ss, ss).mean(axis=(1, 3))
    return _sensor_model(img, t, rng, noise_std, exposure)


def _sensor_model(img: np.ndarray, t: float, rng: np.random.RandomState,
                  noise_std: float, exposure: bool) -> np.ndarray:
    """Exposure drift + vignetting + sensor noise + 8-bit quantization."""
    H, W = img.shape
    if exposure:
        gain, vign = _sensor_gain_vignette(H, W, t)
        img = img * gain * vign
    if noise_std > 0:
        img = img + rng.randn(H, W).astype(np.float32) * noise_std
    # sensor quantization
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)


def _sensor_gain_vignette(H: int, W: int, t: float):
    gain = 1.0 + 0.10 * math.sin(0.45 * t + 0.7)
    yy = (np.arange(H, dtype=np.float32) - H / 2) / (H / 2)
    xx = (np.arange(W, dtype=np.float32) - W / 2) / (W / 2)
    return gain, 1.0 - 0.25 * (yy[:, None] ** 2 + xx[None, :] ** 2) / 2.0


def _sensor_model_torch(img: torch.Tensor, t: float, rng: np.random.RandomState,
                        noise_std: float, exposure: bool) -> torch.Tensor:
    """``_sensor_model`` on a device tensor: the same exposure drift,
    vignetting, numpy-drawn noise and 8-bit quantization."""
    H, W = img.shape
    if exposure:
        gain, vign = _sensor_gain_vignette(H, W, t)
        img = img * gain * torch.as_tensor(vign, device=img.device)
    if noise_std > 0:
        noise = rng.randn(H, W).astype(np.float32) * noise_std
        img = img + torch.as_tensor(noise, device=img.device)
    return torch.clamp(img, 0, 255).to(torch.uint8).to(torch.float32)


def make_raycaster_torch(planes, rays_cam: np.ndarray, ss: int = 1, device=None):
    """The per-frame raycast as tensor work on ``device`` (the card unless
    told otherwise): the counterpart of the reference's
    ``make_raycaster_jax`` -- closest positive hit wins, bilinear texture
    sampling, box pixel integration over the ss x ss subgrid.  Returns
    ``run(R_wc, o_w) -> [H/ss, W/ss]`` float32 (before the sensor model)."""
    dev = resolve_device(device)
    H, W, _ = rays_cam.shape
    rays = torch.as_tensor(rays_cam.reshape(-1, 3), device=dev)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    geo = [(t(pl.p0), t(pl.e1), t(pl.e2), t(pl.normal), float(np.dot(pl.e1, pl.e1)),
            float(np.dot(pl.e2, pl.e2)), t(pl.tex)) for pl in planes]

    def run(R_wc, o_w):
        R, o = t(R_wc), t(o_w)
        d = rays @ R.T  # [N,3] world-frame ray directions
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
            # rays parallel to the plane give NaN; their samples are masked
            # out, the gather only needs an index in range
            fu = torch.nan_to_num(torch.clamp(a, 0.0, 1.0)) * (tw - 1)
            fv = torch.nan_to_num(torch.clamp(b, 0.0, 1.0)) * (th - 1)
            u0 = fu.to(torch.int64)
            v0 = fv.to(torch.int64)
            u1 = torch.clamp(u0 + 1, max=tw - 1)
            v1 = torch.clamp(v0 + 1, max=th - 1)
            au = fu - u0
            av = fv - v0
            val = (tex[v0, u0] * (1 - au) * (1 - av) + tex[v0, u1] * au * (1 - av)
                   + tex[v1, u0] * (1 - au) * av + tex[v1, u1] * au * av)
            best_val = torch.where(ok, val, best_val)
            best_tt = torch.where(ok, tt, best_tt)
        img = best_val.reshape(H, W)
        if ss > 1:
            img = img.reshape(H // ss, ss, W // ss, ss).mean(dim=(1, 3))
        return img

    return run


# ---------------------------------------------------------------- sequence ----


@dataclass
class RenderedSequence:
    """EurocSequence-compatible rendered dataset (frames() + ground_truth())."""

    world: str = "corridor"          # corridor | loop
    seed: int = 0
    n_frames: int = 2000
    span: tuple = (0.0, 1.0)         # fraction of the path covered
    cam: CameraConfig = field(default_factory=CameraConfig)
    noise_std: float = 2.0
    supersample: int = 2      # rendering anti-aliasing factor
    backend: str = "numpy"    # numpy | torch (raycast on ``device``)
    device: Optional[object] = None  # torch backend: the card unless told otherwise
    cache_dir: Optional[str] = None  # per-frame u8 cache (reruns are free)
    _cache: dict = field(default_factory=dict, repr=False)

    def _setup(self):
        if "planes" not in self._cache:
            if self.world == "corridor":
                self._cache["planes"] = corridor_world(self.seed)
                self._cache["traj"] = corridor_trajectory(
                    self.n_frames, self.cam.fps, self.span, self.seed
                )
            elif self.world == "loop":
                self._cache["planes"] = loop_world(self.seed)
                self._cache["traj"] = loop_trajectory(
                    self.n_frames, self.cam.fps, self.span, self.seed
                )
            else:
                raise ValueError(f"unknown world {self.world!r}")
            self._cache["rays"] = pixel_rays(self.cam, ss=self.supersample)
        return self._cache["planes"], self._cache["traj"], self._cache["rays"]

    def _cache_path(self, i: int) -> Optional[str]:
        """The reference's cache file of frame i (same key, same layout)."""
        if self.cache_dir is None:
            return None
        key = (f"{self.world}-s{self.seed}-n{self.n_frames}"
               f"-sp{self.span[0]:g}-{self.span[1]:g}-ss{self.supersample}"
               f"-ns{self.noise_std:g}-w{self.cam.width}x{self.cam.height}-tv{TEXTURE_VERSION}")
        d = os.path.join(self.cache_dir, key)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{i:05d}.npy")

    def _frame_rng(self, i: int) -> np.random.RandomState:
        return np.random.RandomState((self.seed + 991) * 1000003 + i)

    def render_frame(self, i: int):
        """[H,W] float32 frame i: a numpy array, or a tensor on the device
        for the torch backend (read from ``cache_dir`` when it holds it)."""
        if self.backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {self.backend!r}")
        path = self._cache_path(i)
        if path is not None and os.path.exists(path):
            img = np.load(path).astype(np.float32)
            if self.backend == "torch":
                return torch.as_tensor(img, device=resolve_device(self.device))
            return img
        planes, traj, rays = self._setup()
        t, o, R_wc = traj[i]
        rng = self._frame_rng(i)
        if self.backend == "torch":
            if "raycast" not in self._cache:
                self._cache["raycast"] = make_raycaster_torch(planes, rays, self.supersample,
                                                              self.device)
            core = self._cache["raycast"](R_wc, o)
            img = _sensor_model_torch(core, t, rng, self.noise_std, exposure=True)
            if path is not None:
                np.save(path, img.cpu().numpy().astype(np.uint8))
            return img
        img = render(planes, rays, R_wc, o, rng, t=t, noise_std=self.noise_std,
                     ss=self.supersample)
        if path is not None:
            np.save(path, img.astype(np.uint8))
        return img

    def frames(self, start: float = 0.0, limit: Optional[int] = None) -> Iterator[EurocFrame]:
        _, traj, _ = self._setup()
        n = 0
        for i, (t, o, R_wc) in enumerate(traj):
            if t < start:
                continue
            yield EurocFrame(timestamp=t, image=self.render_frame(i))
            n += 1
            if limit is not None and n >= limit:
                return

    def gt_pose(self, i: int):
        """(t, camera center [3], R_wc [3,3]) of frame i."""
        _, traj, _ = self._setup()
        return traj[i]

    def ground_truth(self):
        """(timestamps, camera centers [T,3], quaternions wxyz [T,4]) — exact."""
        _, traj, _ = self._setup()
        ts = np.asarray([t for t, _, _ in traj])
        pos = np.stack([o for _, o, _ in traj]).astype(np.float32)
        quat = np.stack([rot_to_quat_wxyz(R) for _, _, R in traj]).astype(np.float32)
        return ts, pos, quat


def rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Numerically stable rotation->quaternion (w,x,y,z): Shepperd's method,
    branching on the largest of (w,x,y,z) so no division approaches 0/0.
    The w-only formula degenerates when trace(R) -> -1 (yaw near pi, hit on
    every lap of the loop world)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    scores = [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11]
    k = int(np.argmax(scores))
    s = 2.0 * math.sqrt(max(1.0 + scores[k], 1e-12))
    if k == 0:
        q = [s / 4, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s]
    elif k == 1:
        q = [(m21 - m12) / s, s / 4, (m01 + m10) / s, (m02 + m20) / s]
    elif k == 2:
        q = [(m02 - m20) / s, (m01 + m10) / s, s / 4, (m12 + m21) / s]
    else:
        q = [(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, s / 4]
    q = np.asarray(q, np.float64)
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q
