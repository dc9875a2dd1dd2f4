"""Feature matching strategies over dense Hamming distances (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/matching.py`` (the reference's
``ORBmatcher``): every strategy is a masked best-2 over a [Q, T] distance
matrix -- a radius mask for window search, an epipolar mask for
triangulation search, no mask for brute matching -- followed by the
reference's gates: TH_LOW=50 / TH_HIGH=100, the 0.9/0.75 ratio tests, the
rotation histogram and unique target claims.

``match_brute`` (relocalization against the whole landmark arena) takes its
best-2 from ``hamming_kernels.hamming_top2``: the CUDA kernel on the card,
the plain version on the CPU.  The windowed searches keep the dense matrix
(their masks are per pair).
"""

from __future__ import annotations

import math

import torch

from . import hamming, hamming_kernels

TH_LOW = hamming.TH_LOW
TH_HIGH = hamming.TH_HIGH
_DEG = 180.0 / math.pi


def _masked_best2(dist, mask):
    """Best and second-best over the target axis under a mask:
    dist [Q,T] int32, mask [Q,T] bool -> (idx [Q], best [Q], second [Q]),
    masked entries at INVALID_DIST, lowest index first on ties."""
    d = torch.where(mask, dist, hamming.INVALID_DIST)
    return hamming.best2(d, hamming.INVALID_DIST)


def _ratio_ok(best, second, th_dist, nn_ratio):
    return (best <= th_dist) & (best.to(torch.float32) <= nn_ratio * second.to(torch.float32))


def match_in_window(q_uv, q_desc, q_valid, t_xy, t_desc, t_valid, radius,
                    th_dist: int = TH_HIGH, nn_ratio: float = 0.9,
                    t_octave=None, octave_min=None, octave_max=None):
    """Windowed projection search (SearchByProjection family).

    q_uv [Q,2] predicted pixel of each query; radius [Q] or scalar;
    octave_min/max [Q] allowed target octave range.
    Returns (t_idx [Q], dist [Q], matched [Q])."""
    d2 = torch.sum((q_uv[:, None, :] - t_xy[None, :, :]) ** 2, dim=-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=q_uv.device)
    r = torch.broadcast_to(r, (q_uv.shape[0],))
    mask = (d2 <= (r[:, None] ** 2)) & t_valid[None, :] & q_valid[:, None]
    if t_octave is not None and octave_min is not None:
        mask = mask & (t_octave[None, :] >= octave_min[:, None])
        mask = mask & (t_octave[None, :] <= octave_max[:, None])
    idx, best, second = _masked_best2(hamming.hamming_cross(q_desc, t_desc), mask)
    return idx, best, _ratio_ok(best, second, th_dist, nn_ratio) & q_valid


def match_brute(q_desc, q_valid, t_desc, t_valid, th_dist: int = TH_LOW,
                nn_ratio: float = 0.75, q_angle=None, t_angle=None,
                check_rotation: bool = True):
    """Exact full descriptor matching (the reference's BoW-free SearchByBoW:
    TH_LOW + ratio + rotation histogram + unique targets).

    The best-2 is ``hamming_top2``; its "none" (BIG) maps onto the
    reference's INVALID_DIST, so ``ok`` is the reference's and idx/best agree
    wherever ``ok``."""
    idx, best, second = hamming_kernels.hamming_top2(q_desc, q_valid, t_desc, t_valid)
    idx = idx.long()
    best = torch.clamp(best, max=hamming.INVALID_DIST)
    second = torch.clamp(second, max=hamming.INVALID_DIST)
    ok = _ratio_ok(best, second, th_dist, nn_ratio) & q_valid
    if check_rotation and q_angle is not None:
        ok = hamming.rotation_histogram_filter(q_angle * _DEG, t_angle[idx] * _DEG, ok)
    ok = _unique_target(idx, best, ok, t_desc.shape[0])
    return idx, best, ok


def _unique_target(idx, dist, ok, n_targets: int):
    """Drop duplicate claims on a target, keeping the smallest distance and,
    among equals, the first query (the reference's vnMatches21 bookkeeping)."""
    big = hamming.INVALID_DIST + 1
    d = torch.where(ok, dist, big).to(torch.int64)
    best_per_t = torch.full((n_targets,), big, dtype=torch.int64, device=idx.device)
    best_per_t = best_per_t.scatter_reduce(0, idx, d, reduce="amin")
    is_best = ok & (d == best_per_t[idx])
    Q = idx.shape[0]
    qi = torch.arange(Q, device=idx.device)
    first_q = torch.full((n_targets,), Q, dtype=torch.int64, device=idx.device)
    first_q = first_q.scatter_reduce(0, idx, torch.where(is_best, qi, Q), reduce="amin")
    return is_best & (first_q[idx] == qi)


def search_for_initialization(f1_xy, f1_desc, f1_valid, f1_angle, f1_octave,
                              f2_xy, f2_desc, f2_valid, f2_angle, f2_octave,
                              window: float = 100.0, th_dist: int = TH_LOW,
                              nn_ratio: float = 0.9):
    """Two-view bootstrap matching (SearchForInitialization): window search
    over all octaves, ratio + rotation gates, unique targets (the reference
    package's deliberate all-octave deviation, ``matching.py:135-145``)."""
    d2 = torch.sum((f1_xy[:, None, :] - f2_xy[None, :, :]) ** 2, dim=-1)
    mask = (d2 <= window * window) & f1_valid[:, None] & f2_valid[None, :]
    idx, best, second = _masked_best2(hamming.hamming_cross(f1_desc, f2_desc), mask)
    ok = _ratio_ok(best, second, th_dist, nn_ratio) & f1_valid
    ok = hamming.rotation_histogram_filter(f1_angle * _DEG, f2_angle[idx] * _DEG, ok)
    ok = _unique_target(idx, best, ok, f2_xy.shape[0])
    return idx, best, ok


def epipolar_line_dist2(F12, kp1_xy, kp2_xy):
    """[N1, N2] squared distances of kp2 to the epipolar lines of kp1 under
    F12 (lines l2 = x1^T F12, the reference's CheckDistEpipolarLine)."""
    ones1 = torch.ones((*kp1_xy.shape[:-1], 1), dtype=kp1_xy.dtype, device=kp1_xy.device)
    lines = torch.cat([kp1_xy, ones1], dim=-1) @ F12
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * kp2_xy[None, :, 0] + b * kp2_xy[None, :, 1] + c
    return (num * num) / torch.clamp(a * a + b * b, min=1e-12)


def search_for_triangulation(f1_desc, f1_valid, f1_xy, f1_angle, f1_sigma2,
                             f2_desc, f2_valid, f2_xy, f2_angle, f2_sigma2, F12,
                             epi_chi2: float = 3.84, th_dist: int = TH_LOW):
    """Epipolar-constrained matching for new-landmark triangulation
    (SearchForTriangulation)."""
    ed2 = epipolar_line_dist2(F12, f1_xy, f2_xy)
    mask = (ed2 < epi_chi2 * f2_sigma2[None, :]) & f1_valid[:, None] & f2_valid[None, :]
    idx, best, _ = _masked_best2(hamming.hamming_cross(f1_desc, f2_desc), mask)
    ok = (best <= th_dist) & f1_valid
    ok = hamming.rotation_histogram_filter(f1_angle * _DEG, f2_angle[idx] * _DEG, ok)
    ok = _unique_target(idx, best, ok, f2_xy.shape[0])
    return idx, best, ok


def predict_octave(dist, max_dist, scale_factor: float = 1.2, n_levels: int = 8):
    """MapPoint::PredictScale: expected detection octave from viewing distance.

    A NaN distance ratio (a landmark whose ``max_dist`` is NaN) gives octave
    0, as the reference's cast of NaN to int32 does; torch's cast would give
    INT_MIN on the CPU and 0 on the card."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    log_s = torch.log(torch.tensor(scale_factor, dtype=torch.float32, device=ratio.device))
    oct_f = torch.ceil(torch.log(ratio) / log_s)
    oct_f = torch.where(torch.isnan(oct_f), 0.0, oct_f)
    return torch.clamp(oct_f, 0, n_levels - 1).to(torch.int32)
