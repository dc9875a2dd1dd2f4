"""Map and trajectory export to files (the Viewer's replacement, PyTorch).

Counterpart of ``ccm_slam_tpu/io/export.py``.  The reference's ``Viewer``
(cslam/src/Viewer.cpp) publishes RViz markers: keyframe frusta, landmark
clouds, per-agent trajectories and the covisibility graph.  Here the same
content goes to a JSON scene graph and an ASCII PLY point cloud, and the
client's annotated camera frame to an RGB array.  Agent colours are the
reference's defaults (config.yaml Viewer.Color*).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models import map_store as ms

AGENT_COLORS = [  # reference conf/config.yaml Viewer.ColorR/G/B 0..3
    (1.0, 1.0, 1.0),
    (0.0, 0.8, 0.0),
    (0.0, 0.0, 1.0),
    (0.6, 0.0, 0.6),
]
COVIS_COLOR = (0.6, 0.6, 0.6)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def annotate_frame(img, frame, radius: int = 3):
    """Tracked features drawn on a grayscale image (Viewer::DrawFrame):
    keypoints matched to landmarks get filled green discs, the others orange
    rings.  Returns an RGB uint8 array [H,W,3]."""
    img = _np(img)
    h, w = img.shape[:2]
    out = np.stack([img.clip(0, 255).astype(np.uint8)] * 3, axis=-1)
    xy, valid, matched = _np(frame.xy), _np(frame.valid), _np(frame.mp) >= 0
    d = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    r2 = dx * dx + dy * dy
    disc = r2 <= radius * radius
    ring = np.abs(r2 - radius * radius) <= radius
    for i in np.where(valid)[0]:
        x, y = xy[i]
        if not (0 <= x < w and 0 <= y < h):
            continue
        mask, color = (disc, (0, 220, 0)) if matched[i] else (ring, (220, 160, 0))
        yy, xx = int(round(y)) + dy[mask], int(round(x)) + dx[mask]
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        out[yy[inside], xx[inside]] = color
    return out


def export_pointcloud_ply(path: str, m: ms.MapState) -> int:
    """Alive landmarks as an ASCII PLY cloud coloured by agent
    (PubMapPointsAsCloud).  Returns the point count."""
    alive = _np(m.mps.valid & ~m.mps.bad)
    pos = _np(m.mps.pos)[alive]
    client = _np(m.mps.client_id)[alive]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pos)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        for p, c in zip(pos, client):
            r, g, b = AGENT_COLORS[int(c) % len(AGENT_COLORS)]
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{int(r * 255)} {int(g * 255)} {int(b * 255)}\n")
    return len(pos)


def scene_dict(m: ms.MapState, covis_min_weight: int = 100) -> dict:
    """The JSON-able scene graph: keyframe trajectories per agent,
    covisibility edges of at least ``covis_min_weight`` shared landmarks and
    loop edges (PubTrajectories, PubCovGraph and the loop markers)."""
    alive = _np(m.kfs.valid & ~m.kfs.bad)
    centers = _np(m.kfs.center())
    ids = _np(m.kfs.kf_id)
    clients = _np(m.kfs.client_id)

    agents = {}
    for k in np.where(alive)[0]:
        agents.setdefault(int(clients[k]), []).append((int(ids[k]), centers[k].tolist()))
    trajectories = {
        str(c): {
            "color": AGENT_COLORS[c % len(AGENT_COLORS)],
            "keyframes": [p for _, p in sorted(pts)],
            "kf_ids": [i for i, _ in sorted(pts)],
        }
        for c, pts in agents.items()
    }

    W = _np(ms.covisibility_matrix(m))
    ab = np.argwhere(np.triu(np.outer(alive, alive) & (W >= covis_min_weight), k=1))
    edges = [[int(a), int(b), int(W[a, b])] for a, b in ab]

    loops = []
    loop_edges = _np(m.kfs.loop_edges)  # [K,L], stored on both endpoints
    for k in np.where(alive & (loop_edges >= 0).any(axis=1))[0]:
        for e in loop_edges[k][loop_edges[k] >= 0]:
            if k < int(e):
                loops.append([int(k), int(e)])

    return {
        "n_keyframes": int(alive.sum()),
        "n_landmarks": int(_np(m.mps.valid & ~m.mps.bad).sum()),
        "trajectories": trajectories,
        "covisibility_edges": edges,
        "covis_color": COVIS_COLOR,
        "loop_edges": loops,
        "keyframe_centers": {str(int(k)): centers[k].tolist() for k in np.where(alive)[0]},
    }


def export_scene_json(path: str, m: ms.MapState, covis_min_weight: int = 100) -> dict:
    """``scene_dict`` written to a JSON file; returns it."""
    scene = scene_dict(m, covis_min_weight)
    with open(path, "w") as f:
        json.dump(scene, f)
    return scene
