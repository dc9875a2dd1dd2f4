"""Seeded problem builders (numpy), shared by ``chip_smoke.py`` and the tests.

Each builder makes, from the same seed and in the same order of random
draws, the same arrays as its counterpart on the reference side:

  ba_problem_arrays        bench.make_problem (server-scale global BA)
  small_ba_problem_arrays  tests/test_pallas_kernels._small_ba_problem
  arc_problem_arrays       the GBA problem of __graft_entry__.dryrun_multichip
  tracking_arrays          __graft_entry__._synthetic_tracking_args
  stress_problem_arrays    benchmarks/stress.make_stress_problem

``ragged_problem_arrays`` (no counterpart) holds the kernels to their edge
cases: odd sizes and out-of-range camera indices.  ``init_ba_problem_arrays``
(no counterpart) is the client's initialization BA as the tracker lays it
out: two keyframes in a 160 x 24,576 x 16 arena, every empty slot on camera 0.  ``client_map_arrays``
(no counterpart) is a small client map with frames around it, as plain
arrays, so both packages' map, tracking and mapping stages start from the
same state.  ``pose_graph_arrays`` (no counterpart) is a Sim(3) pose graph
(a chain with skip and loop edges, perturbed measurements, drifted
vertices) as ``convert.pose_graph_problem_fields`` gives one.

``make_problem`` wraps the first as the port's ``BAProblem`` on a device.
"""

from __future__ import annotations

import numpy as np

from .convert import ba_problem_from_numpy

INTRINSICS = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0 fx, fy, cx, cy


def _intrinsics() -> dict:
    return {k: np.float32(v) for k, v in zip(("fx", "fy", "cx", "cy"), INTRINSICS)}


def ba_problem_arrays(C=128, P=32768, K=8, seed=0) -> dict:
    """Server-scale GBA problem: C keyframes along a trajectory, P landmarks
    each observed in K (sorted) keyframes, 0.5 px pixel noise, perturbed
    poses and points; the first two cameras fixed (gauge)."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-20, 20, (P, 3)).astype(np.float32)
    X[:, 2] += 30.0
    t = np.cumsum(rs.randn(C, 3).astype(np.float32) * 0.2, axis=0)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    fx, fy, cx, cy = INTRINSICS
    cam_idx = np.sort(rs.randint(0, C, (P, K)).astype(np.int32), axis=1)
    Xc = np.einsum("pkij,pj->pki", R[cam_idx], X) + t[cam_idx]
    z = np.maximum(Xc[..., 2], 1.0)
    uv = np.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], -1).astype(
        np.float32
    )
    uv += rs.randn(P, K, 2).astype(np.float32) * 0.5
    return dict(
        R=R,
        t=t + rs.randn(C, 3).astype(np.float32) * 0.02,
        X=X + rs.randn(P, 3).astype(np.float32) * 0.05,
        cam_idx=cam_idx,
        uv=uv,
        sigma2=np.ones((P, K), np.float32),
        obs_valid=Xc[..., 2] > 1.0,
        cam_fixed=np.arange(C) < 2,
        point_valid=np.ones(P, bool),
        **_intrinsics(),
    )


def small_ba_problem_arrays(P=700, K=4, C=40, seed=0, fixed=2) -> dict:
    """Miniature BA problem with realistic structure: some invalid
    observations and points, fixed cameras, behind-camera points, and 2 px
    noise so that the Huber kernel is active."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-10, 10, (P, 3)).astype(np.float32)
    X[:, 2] += 20.0
    t = np.cumsum(rs.randn(C, 3).astype(np.float32) * 0.3, axis=0)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    fx, fy, cx, cy = INTRINSICS
    cam_idx = rs.randint(0, C, (P, K)).astype(np.int32)
    Xc = np.einsum("pkij,pj->pki", R[cam_idx], X) + t[cam_idx]
    z = np.maximum(Xc[..., 2], 1.0)
    uv = np.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], -1).astype(np.float32)
    uv += rs.randn(P, K, 2).astype(np.float32) * 2.0
    X[:5, 2] = -30.0
    return dict(
        R=R,
        t=t + rs.randn(C, 3).astype(np.float32) * 0.05,
        X=X + rs.randn(P, 3).astype(np.float32) * 0.1,
        cam_idx=cam_idx,
        uv=uv,
        sigma2=1.0 + rs.rand(P, K).astype(np.float32),
        obs_valid=rs.rand(P, K) > 0.15,
        cam_fixed=np.arange(C) < fixed,
        point_valid=rs.rand(P) > 0.05,
        **_intrinsics(),
    )


def ragged_problem_arrays(seed=11) -> dict:
    """An awkward problem for the kernels: P=1001 (a multiple of no block
    size), K=5, C=37 with five fixed cameras, masked observations and
    invalid points, and ~3% of cam_idx out of range (-1, C, C+3)."""
    arr = small_ba_problem_arrays(P=1001, K=5, C=37, seed=seed, fixed=5)
    rs = np.random.RandomState(seed + 1)
    ci = arr["cam_idx"]
    bad = rs.rand(*ci.shape) < 0.03
    arr["cam_idx"] = np.where(bad, rs.choice([-1, 37, 40], ci.shape), ci).astype(np.int32)
    return arr


def arc_problem_arrays(C=256, P=32768, K=4, seed=0) -> dict:
    """A strongly constrained GBA problem: C cameras on a 0.4 rad arc, P
    landmarks each seen by K random (well-spread) cameras, 0.3 px noise;
    free cameras get 1 cm pose noise, points 2 cm; the first two cameras are
    exact and fixed (gauge).  Its optimum is tight, so two solvers can be
    compared by camera centres rather than only by cost."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-6, 6, (P, 3)).astype(np.float32)
    X[:, 2] += 12.0
    ang = np.linspace(0, 0.4, C).astype(np.float32)
    R = np.stack(
        [
            np.array(
                [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                np.float32,
            )
            for a in ang
        ]
    )
    t = np.stack([np.array([0.02 * i, 0.005 * i, 0.0], np.float32) for i in range(C)])
    fx, fy, cx, cy = INTRINSICS
    cam_idx = rs.randint(0, C, (P, K)).astype(np.int32)
    Xc = np.einsum("pkij,pj->pki", R[cam_idx], X) + t[cam_idx]
    uv = np.stack(
        [fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy], -1
    ).astype(np.float32)
    uv += rs.randn(P, K, 2).astype(np.float32) * 0.3
    t_noisy = t + rs.randn(C, 3).astype(np.float32) * 0.01
    t_noisy[:2] = t[:2]
    return dict(
        R=R,
        t=t_noisy,
        X=X + rs.randn(P, 3).astype(np.float32) * 0.02,
        cam_idx=cam_idx,
        uv=uv,
        sigma2=np.ones((P, K), np.float32),
        obs_valid=Xc[..., 2] > 0.1,
        cam_fixed=np.arange(C) < 2,
        point_valid=np.ones(P, bool),
        **_intrinsics(),
    )


def stress_problem_arrays(n_agents=8, kf_per_agent=128, n_landmarks=131072, K=8,
                          seed=0) -> dict:
    """The 8-agent fused-map stress problem (the GBA profiling shape):
    C = n_agents * kf_per_agent keyframes walking parallel corridors over a
    shared field of P = n_landmarks landmarks, K sorted observation slots each
    (E = P * K), 0.5 px noise, perturbed poses and points, the first two
    cameras fixed."""
    rs = np.random.RandomState(seed)
    C = n_agents * kf_per_agent
    P = n_landmarks
    t = np.zeros((C, 3), np.float32)
    for a in range(n_agents):
        base = np.array([0.0, a * 3.0, 0.0], np.float32)
        walk = np.cumsum(rs.randn(kf_per_agent, 3).astype(np.float32) * 0.15, axis=0)
        t[a * kf_per_agent:(a + 1) * kf_per_agent] = base + walk
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    X = rs.uniform(-30, 30, (P, 3)).astype(np.float32)
    X[:, 1] = rs.uniform(-2, n_agents * 3.0, P)
    X[:, 2] += 40.0
    fx, fy, cx, cy = INTRINSICS
    cam_idx = np.sort(rs.randint(0, C, (P, K)).astype(np.int32), axis=1)
    Xc = np.einsum("pkij,pj->pki", R[cam_idx], X) + t[cam_idx]
    z = np.maximum(Xc[..., 2], 1.0)
    uv = np.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], -1).astype(np.float32)
    uv += rs.randn(P, K, 2).astype(np.float32) * 0.5
    return dict(
        R=R,
        t=t + rs.randn(C, 3).astype(np.float32) * 0.03,
        X=X + rs.randn(P, 3).astype(np.float32) * 0.08,
        cam_idx=cam_idx,
        uv=uv,
        sigma2=np.ones((P, K), np.float32),
        obs_valid=Xc[..., 2] > 1.0,
        cam_fixed=np.arange(C) < 2,
        point_valid=np.ones(P, bool),
        **_intrinsics(),
    )


def init_ba_problem_arrays(C=160, P=24576, K=16, n_points=1000, seed=0) -> dict:
    """The client's initialization BA as ``runtime.tracking.build_ba_problem``
    lays it out under ``rendered_ci_config`` (160 keyframe slots, 24,576
    landmark slots, K=16): keyframe 0 at the origin (fixed) and keyframe 1
    0.1 m to its right observe ``n_points`` landmarks in slots 0 and 1 (0.5 px
    noise, perturbed pose and points).  Every other slot is invalid with
    camera index 0, as the clamped ``obs_kf`` of -1 leaves it, so camera 0
    owns nearly all P*K slots; the other landmarks are invalid and the 158
    empty keyframe slots fixed, as dead keyframes are."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-4, 4, (P, 3)).astype(np.float32)
    X[:, 2] += 8.0
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    t[1, 0] = -0.1  # centre (0.1, 0, 0): t = -R c
    cam_idx = np.zeros((P, K), np.int32)
    cam_idx[:n_points, 1] = 1
    fx, fy, cx, cy = INTRINSICS
    Xc = X[:, None, :] + t[cam_idx]
    uv = np.stack([fx * Xc[..., 0] / Xc[..., 2] + cx, fy * Xc[..., 1] / Xc[..., 2] + cy],
                  -1).astype(np.float32)
    uv += rs.randn(P, K, 2).astype(np.float32) * 0.5
    obs_valid = np.zeros((P, K), bool)
    obs_valid[:n_points, :2] = True
    t[1] += rs.randn(3).astype(np.float32) * 0.01
    return dict(
        R=R,
        t=t,
        X=X + rs.randn(P, 3).astype(np.float32) * 0.02,
        cam_idx=cam_idx,
        uv=uv,
        sigma2=np.ones((P, K), np.float32),
        obs_valid=obs_valid,
        cam_fixed=np.arange(C) != 1,
        point_valid=np.arange(P) < n_points,
        **_intrinsics(),
    )


def tracking_arrays(n_points=512, seed=0) -> dict:
    """One pose-only tracking step: N points in front of the camera, their
    0.4 px-noisy projections, and an initial pose a few cm off."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-3, 3, (n_points, 3)).astype(np.float32)
    X[:, 2] += 10.0
    fx, fy, cx, cy = INTRINSICS
    uv = np.stack(
        [fx * X[:, 0] / X[:, 2] + cx, fy * X[:, 1] / X[:, 2] + cy], -1
    ).astype(np.float32)
    uv += rs.randn(n_points, 2).astype(np.float32) * 0.4
    return dict(
        R0=np.eye(3, dtype=np.float32),
        t0=np.array([0.05, -0.03, 0.02], np.float32),
        X=X,
        uv=uv,
        valid=np.ones(n_points, bool),
        sigma2=np.ones(n_points, np.float32),
    )


def make_problem(C=128, P=32768, K=8, seed=0, device=None):
    """``ba_problem_arrays`` as the port's BAProblem (on the card by default)."""
    return ba_problem_from_numpy(ba_problem_arrays(C, P, K, seed), device)


def _yaw_pose(center, yaw):
    """(R_cw, t_cw) of a camera at ``center`` looking along +z, turned by
    ``yaw`` about the y axis."""
    c, s = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    R_cw = R_wc.T
    return R_cw, (-R_cw @ np.asarray(center, np.float32)).astype(np.float32)


def client_map_arrays(n_kf=6, n_frames=3, kf_cap=16, mp_cap=512, n_feat=128, max_obs=16,
                      n_points=320, mapped_frac=0.7, seed=0):
    """A small client map and the frames that follow it, as numpy arrays.

    World points in front of a camera sliding sideways with a slight yaw;
    ``n_kf`` keyframes (poses 0..n_kf-1) observe the visible points at
    shuffled feature slots (0.5 px noise, octaves 0-2, a few flipped
    descriptor bits).  A ``mapped_frac`` share of the points are landmarks
    (perturbed 2 cm, linked both ways, at most ``max_obs`` observations);
    the rest stay free features, so triangulation has work.  Landmark normals
    and distances are placeholders (callers run ``update_normal_and_depth``).

    Returns (map fields as ``convert.map_state_fields`` gives them, frames:
    a list of ``n_frames`` frame field dicts at poses n_kf.. with identity
    pose and no associations, and the true (R_cw, t_cw) of every pose)."""
    rs = np.random.RandomState(seed)
    fx, fy, cx, cy = INTRINSICS
    pts = np.stack([rs.uniform(-4, 6, n_points), rs.uniform(-2.5, 2.5, n_points),
                    rs.uniform(4, 9, n_points)], 1).astype(np.float32)
    wdesc = rs.randint(0, 256, (n_points, 32)).astype(np.uint8)
    poses = [_yaw_pose((0.12 * i, 0.01 * np.sin(i), 0.03 * i), 0.01 * i)
             for i in range(n_kf + n_frames)]

    def observe(R, t):
        Xc = pts @ R.T + t
        z = Xc[:, 2]
        uv = np.stack([fx * Xc[:, 0] / np.maximum(z, 1e-6) + cx,
                       fy * Xc[:, 1] / np.maximum(z, 1e-6) + cy], -1)
        vis = np.where((z > 0.5) & (uv[:, 0] > 10) & (uv[:, 0] < 742) & (uv[:, 1] > 10)
                       & (uv[:, 1] < 470))[0][:n_feat]
        rs.shuffle(vis)
        n = len(vis)
        octave = np.zeros(n_feat, np.int32)
        octave[:n] = rs.randint(0, 3, n)
        xy = np.zeros((n_feat, 2), np.float32)
        xy[:n] = uv[vis] + rs.randn(n, 2) * 0.5 * 1.2 ** octave[:n, None]
        desc = np.zeros((n_feat, 32), np.uint8)
        d = wdesc[vis].copy()
        byte, bit = rs.randint(0, 32, n), rs.randint(0, 8, n)
        d[np.arange(n), byte] ^= (1 << bit).astype(np.uint8)
        desc[:n] = d
        valid = np.arange(n_feat) < n
        point = np.full(n_feat, -1, np.int64)
        point[:n] = vis
        return xy, desc, octave, valid, point

    mapped = rs.rand(n_points) < mapped_frac
    lm_of_point = np.full(n_points, -1, np.int64)
    lm_of_point[mapped] = np.arange(mapped.sum())
    n_lm = int(mapped.sum())

    K, M, N, O = kf_cap, mp_cap, n_feat, max_obs
    kfs = dict(
        kf_id=np.full(K, -1, np.int32), client_id=np.zeros(K, np.int32),
        timestamp=np.zeros(K, np.float32), valid=np.arange(K) < n_kf, bad=np.zeros(K, bool),
        insert_order=np.where(np.arange(K) < n_kf, np.arange(K), 2**31 - 1).astype(np.int32),
        R_cw=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), t_cw=np.zeros((K, 3), np.float32),
        pose_version=np.zeros(K, np.int32), xy=np.zeros((K, N, 2), np.float32),
        desc=np.zeros((K, N, 32), np.uint8), octave=np.zeros((K, N), np.int32),
        angle=np.zeros((K, N), np.float32), feat_valid=np.zeros((K, N), bool),
        mp_idx=np.full((K, N), -1, np.int32), parent=np.full(K, -1, np.int32),
        loop_edges=np.full((K, 4), -1, np.int32),
    )
    obs = [[] for _ in range(n_lm)]
    for k in range(n_kf):
        R, t = poses[k]
        xy, desc, octave, valid, point = observe(R, t)
        kfs["kf_id"][k] = k
        kfs["timestamp"][k] = 0.25 * k
        kfs["R_cw"][k], kfs["t_cw"][k] = R, t
        kfs["xy"][k], kfs["desc"][k], kfs["octave"][k], kfs["feat_valid"][k] = (
            xy, desc, octave, valid)
        for f in np.where(valid)[0]:
            p = lm_of_point[point[f]]
            if p >= 0 and len(obs[p]) < O:
                kfs["mp_idx"][k, f] = p
                obs[p].append((k, f))

    ref = np.array([o[0][0] if o else 0 for o in obs], np.int32)
    alive = np.array([len(o) > 0 for o in obs])
    mps = dict(
        mp_id=np.full(M, -1, np.int32), client_id=np.zeros(M, np.int32),
        valid=np.zeros(M, bool), bad=np.zeros(M, bool), pos=np.zeros((M, 3), np.float32),
        pos_version=np.zeros(M, np.int32), normal=np.zeros((M, 3), np.float32),
        desc=np.zeros((M, 32), np.uint8), min_dist=np.zeros(M, np.float32),
        max_dist=np.full(M, np.inf, np.float32), ref_kf=np.full(M, -1, np.int32),
        first_kf_id=np.full(M, -1, np.int32), n_visible=np.ones(M, np.int32),
        n_found=np.ones(M, np.int32), obs_kf=np.full((M, O), -1, np.int32),
        obs_feat=np.zeros((M, O), np.int32), obs_n=np.zeros(M, np.int32),
    )
    mps["mp_id"][:n_lm] = np.arange(n_lm)
    mps["valid"][:n_lm] = alive
    mps["bad"][:n_lm] = ~alive
    mps["pos"][:n_lm] = pts[mapped] + rs.randn(n_lm, 3).astype(np.float32) * 0.02
    mps["normal"][:n_lm] = (0.0, 0.0, 1.0)
    mps["desc"][:n_lm] = wdesc[mapped]
    mps["ref_kf"][:n_lm] = ref
    mps["first_kf_id"][:n_lm] = ref
    for p, o in enumerate(obs):
        mps["obs_n"][p] = len(o)
        for s, (k, f) in enumerate(o):
            mps["obs_kf"][p, s], mps["obs_feat"][p, s] = k, f
    fields = dict(kfs=kfs, mps=mps, next_kf=np.int32(n_kf), next_mp=np.int32(n_lm),
                  insert_counter=np.int32(n_kf))

    frames = []
    for i in range(n_kf, n_kf + n_frames):
        xy, desc, octave, valid, _ = observe(*poses[i])
        frames.append(dict(
            timestamp=np.float32(0.25 * i), xy=xy, desc=desc, octave=octave,
            angle=np.zeros(N, np.float32), sigma2=(1.2 ** (2 * octave)).astype(np.float32),
            valid=valid, R_cw=np.eye(3, dtype=np.float32), t_cw=np.zeros(3, np.float32),
            mp=np.full(N, -1, np.int32)))
    return fields, frames, poses


def pose_graph_arrays(V=14, seed=0, noise=0.02):
    """A chain of V Sim3 vertices along z with a yaw wave, skip edges (i, i-2)
    on even i and two loop edges back to vertices 0 and 1; the measurements
    are the true relative poses perturbed by ``noise``, the vertices start
    drifted in proportion to their index, vertex 0 is fixed and vertex
    V//2 + 1 invalid, edge 3 invalid; weights in [0.5, 1.5].  No edge error
    is exactly the identity."""
    import torch

    from .solvers.pose_graph import relative_sim3
    from .utils.lie import Sim3

    rng = np.random.default_rng(seed)
    xi = np.zeros((V, 7), np.float32)
    xi[:, 2] = -np.arange(V)
    xi[:, 4] = 0.3 * np.sin(np.arange(V)) + 0.2
    gt = Sim3.exp(torch.as_tensor(xi))
    ii = np.asarray(list(range(1, V)) + list(range(2, V, 2)) + [V - 1, V - 2], np.int32)
    jj = np.asarray(list(range(0, V - 1)) + list(range(0, V - 2, 2)) + [0, 1], np.int32)
    E = len(ii)

    S_ij = Sim3.exp(torch.as_tensor(rng.normal(0, noise, (E, 7)), dtype=torch.float32)).compose(
        relative_sim3(gt[torch.as_tensor(ii).long()], gt[torch.as_tensor(jj).long()]))
    drift = rng.normal(0, 0.05, (V, 7)) * (np.arange(V) / V)[:, None]
    S_w = Sim3.exp(torch.as_tensor(drift, dtype=torch.float32)).compose(gt)
    edge_valid = np.ones(E, bool)
    edge_valid[3] = False

    def fields(S):
        return {k: getattr(S, k).numpy().copy() for k in ("s", "R", "t")}

    return dict(S_w=fields(S_w), fixed=np.arange(V) == 0, vert_valid=np.arange(V) != V // 2 + 1,
                i_idx=ii, j_idx=jj, S_meas=fields(S_ij), edge_valid=edge_valid,
                weight=rng.uniform(0.5, 1.5, E).astype(np.float32))
