"""Deterministic synthetic worlds for tests and deployment smoke runs.

Counterpart of ``ccm_slam_tpu/io/synthetic.py``: a shared 3-D landmark field
with random binary descriptors, and per-agent keyframe maps built along
straight corridors in arbitrary monocular gauges (scale, rotation and offset
per agent: the Sim(3) ambiguity every client map carries,
CentralControl's mg2oS_wcurmap_wclientmap).  The world is numpy from a
``RandomState``; the maps are built on ``device`` (the card unless told
otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import map_store as ms
from ..utils.lie import SE3, Sim3, so3_exp

N_FEAT = 96
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375


def make_world(rng: np.random.RandomState, n: int = 260):
    """Landmark field in front of the corridor plane: positions [n,3] and
    random 256-bit descriptors [n,32]."""
    lx = rng.uniform(-2, 6, n)
    ly = rng.uniform(-1.5, 1.5, n)
    lz = rng.uniform(5.5, 7.0, n)
    return np.stack([lx, ly, lz], 1).astype(np.float32), rng.randint(
        0, 256, (n, 32), dtype=np.uint8
    )


def build_agent_map(world, wdesc, xs, gauge: Sim3, kf_id_base: int = 0,
                    client_id: int = 0, n_feat: int = N_FEAT,
                    kf_cap: int = 16, mp_cap: int = 1024, device=None):
    """Client map with keyframes at world x positions ``xs`` looking +z,
    stored in ``gauge``'s frame (world' = gauge(world)): the state a
    monocular client has after drift and scale ambiguity."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    gauge = Sim3(s=gauge.s.to(dev), R=gauge.R.to(dev), t=gauge.t.to(dev))
    m = ms.empty_map(kf_cap, mp_cap, n_feat, 8, dev)
    lm_arena = {}
    lx = world[:, 0]
    for k, xt in enumerate(xs):
        T_true = SE3(R=torch.eye(3, **f32), t=-torch.tensor([xt, 0.0, 0.0], **f32))
        vis = np.where(np.abs(lx - xt) < 1.6)[0][:n_feat]
        Xc = T_true.apply(torch.as_tensor(world[vis], **f32)).cpu().numpy()
        uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], 1)
        n = len(vis)
        new = [wi for wi in vis if wi not in lm_arena]
        if new:
            B = len(new)
            pos = gauge.apply(torch.as_tensor(world[new], **f32)).cpu().numpy()
            pad = max(0, n_feat - B)
            m, idxs = ms.add_mappoints(
                m,
                n_new=torch.tensor(B, **i32),
                pos=torch.as_tensor(np.pad(pos, ((0, pad), (0, 0)))[:n_feat], **f32),
                desc=torch.as_tensor(
                    np.pad(np.stack([wdesc[w] for w in new]), ((0, pad), (0, 0)))[:n_feat],
                    device=dev),
                normal=torch.tensor([0.0, 0.0, -1.0], **f32).repeat(n_feat, 1),
                min_dist=torch.full((n_feat,), 0.01, **f32),
                max_dist=torch.full((n_feat,), 100.0, **f32),
                ref_kf=torch.full((n_feat,), k, **i32),
                mp_ids=torch.arange(n_feat, **i32) + k * n_feat,
                client_id=torch.full((n_feat,), client_id, **i32),
                new_valid=torch.arange(n_feat, device=dev) < B,
            )
            idxs = idxs.cpu().numpy()
            for bi, wi in enumerate(new):
                lm_arena[wi] = int(idxs[bi])
        assoc = np.full(n_feat, -1, np.int32)
        for j, wi in enumerate(vis):
            assoc[j] = lm_arena[wi]
        # pose in the gauge frame: T'_cw = se3( T_cw o gauge^-1 )
        T_est = T_true.to_sim3().compose(gauge.inverse()).to_se3_scaled()
        xy = np.zeros((n_feat, 2), np.float32)
        xy[:n] = uv
        desc = np.zeros((n_feat, 32), np.uint8)
        desc[:n] = wdesc[vis]
        valid = np.zeros(n_feat, bool)
        valid[:n] = True
        m, _ = ms.add_keyframe(
            m, kf_id_base + k, client_id, k * 0.5, T_est.R, T_est.t,
            torch.as_tensor(xy, device=dev), torch.as_tensor(desc, device=dev),
            torch.zeros(n_feat, **i32), torch.zeros(n_feat, **f32),
            torch.as_tensor(valid, device=dev), torch.as_tensor(assoc, device=dev),
        )
    return m


def agent_corridor(agent_id: int, n_kfs: int = 4):
    """Standard per-agent corridor: staggered, overlapping x ranges so any
    two consecutive agents share enough landmarks to map-match."""
    x0 = 0.0 + 1.0 * agent_id
    step = 1.0 if agent_id % 2 == 0 else -1.0
    xs = [x0 + step * k for k in range(n_kfs)]
    if step < 0:
        xs = [x + n_kfs - 1 for x in xs]
    return xs


def agent_gauge(agent_id: int, device=None) -> Sim3:
    """Deterministic per-agent monocular gauge (agent 0 = identity), on
    ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    if agent_id == 0:
        return Sim3.identity(device=dev)
    rs = np.random.RandomState(1000 + agent_id)
    return Sim3(
        s=torch.tensor(1.0 + 0.25 * agent_id, dtype=torch.float32, device=dev),
        R=so3_exp(torch.as_tensor(rs.uniform(-0.05, 0.05, 3).astype(np.float32), device=dev)),
        t=torch.as_tensor(rs.uniform(-0.3, 0.3, 3).astype(np.float32), device=dev),
    )
