"""Seeded problem builders (numpy), shared by ``chip_smoke.py`` and the tests.

Each builder makes, from the same seed and in the same order of random
draws, the same arrays as its counterpart on the reference side:

  ba_problem_arrays        bench.make_problem (server-scale global BA)
  small_ba_problem_arrays  tests/test_pallas_kernels._small_ba_problem
  arc_problem_arrays       the GBA problem of __graft_entry__.dryrun_multichip
  tracking_arrays          __graft_entry__._synthetic_tracking_args

``ragged_problem_arrays`` (no counterpart) holds the kernels to their edge
cases: odd sizes and out-of-range camera indices.

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
