"""Seeded server maps for global BA, in the server's arena, made on the
device in a few large calls.

A map is what the server's global BA solves (``Server._run_gba`` through
``tracking.build_ba_problem``): the whole arena of ``C`` keyframe slots and
``P`` landmark slots with ``K`` observation slots each, of which a run has
filled a part.  The arena's sizes follow the server's growth rule (64
keyframes and 8,192 landmarks, doubled while the fill reaches 85%); ``K``
is the program's ``max_obs_per_mp``.  Empty keyframe slots are fixed
cameras nobody observes, empty landmark slots are invalid points.

The fill has the shape of a tracked map (the traffic's ``map`` gives the
numbers, read from the client cell's own map: ``portbench/map_stats.py``):

* ``agents`` agents each leave ``kf_per_agent`` keyframes along a corridor
  (steps of ``step_m``, cameras looking ahead at +z); the corridors run
  side by side 3 m apart, and the agents' first ``shared_kf`` keyframes
  lie in one junction, where the corridors meet;
* each keyframe brings ``landmarks_per_kf`` new landmarks, ``depth_m``
  ahead of the keyframe that made it;
* a landmark's number of observations n is drawn from ``obs_hist`` (counts
  of landmarks by observations), its observers from the keyframes within
  max(``window_kf``, n) of its own keyframe in the same agent's sequence,
  and, in the junction, in every agent's;
* each observation's pyramid octave is drawn from ``octave_hist``; its
  variance is 1.2^(2 octave) and its pixel noise ``noise_px`` x 1.2^octave;
* poses and points start perturbed by ``pose_noise_m`` and
  ``point_noise_m``; the two oldest keyframes are fixed (the gauge).

Every seed solves one map, drawn from the traffic's ``base_seed``, with its
keyframe and landmark slots in orders drawn from the run's seed
(``relabel``): the same problem, other inputs.

A map is a dict of tensors: R [C,3,3], t [C,3], X [P,3], cam_idx [P,K] int32,
uv [P,K,2], sigma2 [P,K], obs_valid [P,K] bool, cam_fixed [C] bool,
point_valid [P] bool and intr [4] (fx, fy, cx, cy).
"""

from __future__ import annotations

import torch

INTRINSICS = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0


def arena(n, start):
    """The server's arena size for ``n`` entries (``Server.ensure_capacity``)."""
    cap = start
    while n >= (cap * 17) // 20:
        cap *= 2
    return cap


def _draw(hist, n, g, dev):
    """``n`` draws of the index of ``hist`` with its weights."""
    w = torch.tensor(hist, dtype=torch.float32, device=dev)
    return torch.multinomial(w, n, replacement=True, generator=g)


def corridors(seed, dev, agents, kf_per_agent, landmarks_per_kf, obs_hist, window_kf, shared_kf,
              octave_hist, slots, step_m=0.2, depth_m=(4.0, 12.0), noise_px=0.5,
              pose_noise_m=0.03, point_noise_m=0.08):
    """The map of the module docstring, its slots in arena order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A, B, K, W = agents, kf_per_agent, slots, window_kf
    n_kf = A * B
    C, n_mp = arena(n_kf, 64), int(round(n_kf * landmarks_per_kf))
    P = arena(n_mp, 8192)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # keyframe centres [A, B, 3]: a walk along +x, the corridors 3 m apart
    # past the junction
    x = torch.cumsum(step_m * (1.0 + 0.3 * randn(A, B)), dim=1)
    idx = torch.arange(B, device=dev, dtype=torch.float32)
    lane = torch.arange(A, device=dev, dtype=torch.float32)[:, None] * 3.0
    y = lane * torch.clamp((idx[None, :] - shared_kf) / 10.0, 0.0, 1.0) + 0.05 * randn(A, B)
    centre = torch.stack([x, y, 0.05 * randn(A, B)], -1).reshape(n_kf, 3)

    # landmarks: an owner keyframe each, observers within the window
    owner = torch.arange(n_mp, device=dev) % n_kf
    oa, ob = owner // B, owner % B
    n_obs = _draw(obs_hist, n_mp, g, dev).clamp(2, K)
    Wm = max(W, K)
    off = torch.arange(-Wm, Wm + 1, device=dev)
    cb = ob[:, None, None] + off[None, None, :]                      # [n_mp, 1, 2Wm+1]
    ca = torch.arange(A, device=dev)[None, :, None].expand(n_mp, A, 2 * Wm + 1)
    reach = torch.clamp(n_obs, min=W)[:, None, None]
    cand_ok = (cb >= 0) & (cb < B) & (off.abs()[None, None, :] <= reach) & (
        (ca == oa[:, None, None]) | ((ob[:, None, None] < shared_kf) & (cb < shared_kf)))
    key = torch.where(cand_ok, rand(n_mp, A, 2 * Wm + 1), 2.0)
    key = torch.where((ca == oa[:, None, None]) & (cb == ob[:, None, None]), -1.0, key)
    cand = (ca * B + cb.clamp(0, B - 1)).reshape(n_mp, -1)
    pick = torch.argsort(key.reshape(n_mp, -1), dim=1)[:, :K]
    obs_kf = torch.gather(cand, 1, pick)
    ok = (torch.gather(key.reshape(n_mp, -1), 1, pick) < 2.0) & (
        torch.arange(K, device=dev)[None, :] < n_obs[:, None])
    obs_kf = torch.where(ok, obs_kf, n_kf)          # unfilled slots sort last
    obs_kf = torch.sort(obs_kf, dim=1).values
    ok = obs_kf < n_kf
    obs_kf = torch.where(ok, obs_kf, 0)

    # positions ahead of the observers' mean centre
    w = ok.float()
    mean = torch.einsum("pk,pkj->pj", w, centre[obs_kf]) / w.sum(1, keepdim=True)
    X = mean + torch.stack([rand(n_mp) - 0.5, rand(n_mp) - 0.5,
                            depth_m[0] + (depth_m[1] - depth_m[0]) * rand(n_mp)], -1)

    octave = _draw(octave_hist, n_mp * K, g, dev).reshape(n_mp, K).float()
    scale = torch.pow(torch.tensor(1.2, device=dev), octave)
    fx, fy, cx, cy = INTRINSICS
    Xc = X[:, None, :] - centre[obs_kf]                                 # R = I, t = -centre
    uv = torch.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy], -1)
    uv = uv + noise_px * scale[..., None] * randn(n_mp, K, 2)

    R = torch.eye(3, device=dev).repeat(C, 1, 1)
    t = torch.zeros(C, 3, device=dev)
    t[:n_kf] = -centre + pose_noise_m * randn(n_kf, 3)
    cam_fixed = torch.ones(C, dtype=torch.bool, device=dev)
    cam_fixed[2:n_kf] = False

    def table(v, fill):
        out = torch.full((P, K, *v.shape[2:]), fill, dtype=v.dtype, device=dev)
        out[:n_mp] = v
        return out

    Xa = torch.zeros(P, 3, device=dev)
    Xa[:n_mp] = X + point_noise_m * randn(n_mp, 3)
    point_valid = torch.zeros(P, dtype=torch.bool, device=dev)
    point_valid[:n_mp] = True
    return dict(R=R, t=t, X=Xa, cam_idx=table(obs_kf.to(torch.int32), 0),
                uv=table(torch.where(ok[..., None], uv, 0.0), 0.0).contiguous(),
                sigma2=table(torch.where(ok, scale * scale, 1.0), 1.0),
                obs_valid=table(ok, False), cam_fixed=cam_fixed, point_valid=point_valid,
                intr=torch.tensor(INTRINSICS, dtype=torch.float32, device=dev))


GENERATORS = dict(corridors=corridors)


def relabel(m, seed):
    """The same map with its keyframe slots (all but the two fixed ones) and
    its landmark slots in an order drawn from ``seed``, each landmark's
    observations in keyframe order again: the same problem, other inputs."""
    dev = m["R"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    C, (P, K) = m["R"].shape[0], m["cam_idx"].shape
    pc = torch.cat([torch.arange(2, device=dev), 2 + torch.randperm(C - 2, generator=g,
                                                                    device=dev)])
    new_of = torch.empty_like(pc).index_put_((pc,), torch.arange(C, device=dev))
    pp = torch.randperm(P, generator=g, device=dev)
    valid = m["obs_valid"][pp]
    ci = torch.where(valid, new_of[m["cam_idx"][pp].long()], 0)
    order = torch.sort(torch.where(valid, ci, C), dim=1, stable=True).indices

    def rows(x):
        x = x[pp]
        idx = order.reshape(P, K, *([1] * (x.dim() - 2))).expand_as(x)
        return torch.gather(x, 1, idx)

    return dict(R=m["R"][pc], t=m["t"][pc], X=m["X"][pp],
                cam_idx=torch.gather(ci, 1, order).to(torch.int32), uv=rows(m["uv"]).contiguous(),
                sigma2=rows(m["sigma2"]), obs_valid=rows(m["obs_valid"]),
                cam_fixed=m["cam_fixed"][pc], point_valid=m["point_valid"][pp], intr=m["intr"])


def make_map(traffic, seed, dev):
    """The map a traffic file describes: the ``generator``'s map of its
    sizes from the fixed ``base_seed``, relabelled by ``seed``."""
    spec = dict(traffic["map"])
    gen, base = GENERATORS[spec.pop("generator")], spec.pop("base_seed")
    return relabel(gen(base, dev, **spec), seed)

