"""Monocular two-view bootstrap: batched H/F RANSAC, model selection, motion
recovery, triangulation (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/initializer.py`` (the reference's
``Initializer``): every hypothesis of both models is evaluated in one
batched pass, with the reference's scoring rules -- F gate chi2 3.841 and
score 5.991 - chi2 in both directions, H gate/score 5.991, homography when
S_H / (S_H + S_F) > 0.40, E decomposed into 4 motions, H into Faugeras' 8,
CheckRT's depth / parallax / reprojection gates.

RANSAC samples are an input: ``idx_f [n,8]`` / ``idx_h [n,4]`` (the tests
pass the JAX key's draws); without them they are drawn, with replacement
and in proportion to ``valid`` (uniform when nothing is valid, as the
reference's ``categorical`` over ``log(valid + 1e-12)``), from ``generator``.

SVD signs differ between LAPACK and cuSOLVER; the candidate sets of
``_decompose_e`` / ``_decompose_h`` are closed under those sign flips but
their order is not, so only the chosen motion is comparable across
implementations (``success`` needs a unique well-supported candidate).
"""

from __future__ import annotations

import torch


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _normalize(pts, valid):
    """Mean/abs-dev normalization (Initializer::Normalize): (pts_norm, T)
    with T mapping raw -> normalized homogeneous."""
    w = valid.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(pts - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    T = _eye(3, pts).clone()
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (pts - mean) * s, T


def _null_vector(A):
    """The right singular vector of the smallest singular value, [..., n]."""
    return torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]


def _dlt_f(p1, p2):
    """8-point fundamental per hypothesis: p1,p2 [B,8,2] -> F [B,3,3] rank 2."""
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    U, D, Vt = torch.linalg.svd(F)
    D = D * torch.tensor([1.0, 1.0, 0.0], dtype=D.dtype, device=D.device)
    return U @ torch.diag_embed(D) @ Vt


def _dlt_h(p1, p2):
    """4-point homography (x2 ~ H x1): p1,p2 [B,4,2] -> H [B,3,3]."""
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _score_f(F, p1, p2, valid, sigma: float = 1.0):
    """(score [B], inlier_mask [B,N]) per CheckFundamental, F [B,3,3]."""
    th, th_score = 3.841, 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    x1, x2 = _homog(p1), _homog(p2)
    l2 = x1 @ F.transpose(-1, -2)  # lines in image 2 (F x1)
    l1 = x2 @ F                    # lines in image 1 (F^T x2)
    d2 = torch.sum(l2 * x2, -1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * x1, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    c1, c2 = d1 * inv_s2, d2 * inv_s2
    good = (c1 < th) & (c2 < th) & valid
    score = torch.sum(torch.where(valid & (c1 < th), th_score - c1, 0.0)
                      + torch.where(valid & (c2 < th), th_score - c2, 0.0), dim=-1)
    return score, good


def _dehomog(x):
    z = x[..., 2:3]
    return x[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)


def _score_h(H, p1, p2, valid, sigma: float = 1.0):
    """(score [B], inlier_mask [B,N]) per CheckHomography (symmetric transfer)."""
    th = 5.991
    inv_s2 = 1.0 / (sigma * sigma)
    x1, x2 = _homog(p1), _homog(p2)
    Hinv = torch.linalg.inv(H + 1e-12 * _eye(3, H))
    c2 = torch.sum((_dehomog(x1 @ H.transpose(-1, -2)) - p2) ** 2, -1) * inv_s2
    c1 = torch.sum((_dehomog(x2 @ Hinv.transpose(-1, -2)) - p1) ** 2, -1) * inv_s2
    good = (c1 < th) & (c2 < th) & valid
    score = torch.sum(torch.where(valid & (c1 < th), th - c1, 0.0)
                      + torch.where(valid & (c2 < th), th - c2, 0.0), dim=-1)
    return score, good


def triangulate(P1, P2, p1, p2):
    """Linear DLT triangulation.  P1, P2 [...,3,4] projection matrices (they
    broadcast against the points' leading axes); p1, p2 [...,2] pixels.
    Returns [...,3] points."""
    A = torch.stack(torch.broadcast_tensors(
        p1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        p1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        p2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        p2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ), dim=-2)
    X = torch.linalg.svd(A).Vh[..., -1, :]
    w = X[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w_safe[..., None]


def _check_rt(R, t, p1, p2, valid, K, sigma2: float = 1.0, th2: float = 4.0):
    """CheckRT for a batch of motions R [B,3,3], t [B,3]: triangulate and
    count points passing depth / parallax / reprojection gates.
    Returns (n_good [B], good_mask [B,N], X [B,N,3], parallax_deg [B])."""
    P1 = K @ torch.cat([_eye(3, K), torch.zeros(3, 1, dtype=K.dtype, device=K.device)], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)  # [B,3,4]
    X = triangulate(P1, P2[:, None], p1[None], p2[None])  # [B,N,3] in cam1 frame
    finite = torch.all(torch.isfinite(X), dim=-1)

    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # camera-2 centre in cam1 frame
    n1, n2 = X, X - O2[:, None]
    cos_par = torch.sum(n1 * n2, -1) / torch.clamp(
        torch.linalg.norm(n1, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    Xc2 = X @ R.transpose(-1, -2) + t[:, None]
    z1, z2 = X[..., 2], Xc2[..., 2]

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def pix(Xc, z):
        zs = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
        return fx * Xc[..., 0] / zs + cx, fy * Xc[..., 1] / zs + cy

    u1, v1 = pix(X, z1)
    u2, v2 = pix(Xc2, z2)
    e1 = (u1 - p1[:, 0]) ** 2 + (v1 - p1[:, 1]) ** 2
    e2 = (u2 - p2[:, 0]) ** 2 + (v2 - p2[:, 1]) ** 2

    # a near-zero-parallax point counts toward nGood whatever its depth sign,
    # but never becomes a landmark (Initializer::CheckRT, :794)
    low_par = cos_par >= 0.99998
    counted = (valid & finite & ((z1 > 0) | low_par) & ((z2 > 0) | low_par)
               & (e1 < th2 * sigma2) & (e2 < th2 * sigma2))
    good = counted & ~low_par
    # parallax statistic: the counted cosines sorted ascending, index min(50, n-1)
    cos_sorted = torch.sort(torch.where(counted, cos_par, 2.0), dim=-1).values
    n_counted = torch.sum(counted, dim=-1)
    idx = torch.clamp(torch.minimum(n_counted - 1, torch.full_like(n_counted, 50)),
                      0, cos_sorted.shape[-1] - 1)
    c = torch.gather(cos_sorted, -1, idx[:, None])[:, 0]
    parallax = torch.where(n_counted > 0, torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0))),
                           0.0)
    return n_counted, good, X, parallax


def _decompose_e(E):
    """E -> (R1, R2, t) with |t| = 1 (Initializer::DecomposeE)."""
    U, _, Vt = torch.linalg.svd(E)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vt
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _decompose_h(H, K):
    """Faugeras decomposition of a calibrated homography into 8 (R, t)
    candidates (Initializer::ReconstructH)."""
    A = torch.linalg.inv(K) @ H @ K
    U, D, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    kw = dict(dtype=H.dtype, device=H.device)

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    signs = ((1, 1, 1.0), (1, -1, -1.0), (-1, 1, -1.0), (-1, -1, 1.0))

    Rs, ts = [], []
    # case d' = +d2
    sin_t = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for e1, e3, sgn in signs:
        st = sgn * sin_t
        z, o = torch.zeros((), **kw), torch.ones((), **kw)
        Rp = torch.stack([torch.stack([cos_t, z, -st]), torch.stack([z, o, z]),
                          torch.stack([st, z, cos_t])])
        tp = torch.stack([e1 * aux1, z, -e3 * aux3]) * (d1 - d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    # case d' = -d2
    sin_p = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for e1, e3, sgn in signs:
        sp = sgn * sin_p
        z, o = torch.zeros((), **kw), torch.ones((), **kw)
        Rp = torch.stack([torch.stack([cos_p, z, sp]), torch.stack([z, -o, z]),
                          torch.stack([sp, z, -cos_p])])
        tp = torch.stack([e1 * aux1, z, e3 * aux3]) * (d1 + d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    R8 = torch.stack(Rs)
    t8 = torch.stack(ts)
    return R8, t8 / torch.clamp(torch.linalg.norm(t8, dim=-1, keepdim=True), min=1e-12)


def draw_samples(valid, n_hypotheses: int, size: int, generator=None):
    """[n_hypotheses, size] int64 indices drawn with replacement in proportion
    to ``valid`` (uniform when nothing is valid), from ``generator``."""
    w = valid.to(torch.float32) + 1e-12
    idx = torch.multinomial(w, n_hypotheses * size, replacement=True, generator=generator)
    return idx.reshape(n_hypotheses, size)


def initialize_two_view(p1, p2, valid, K, sigma: float = 1.0, n_hypotheses: int = 200,
                        min_triangulated: int = 50, min_parallax_deg: float = 1.0,
                        idx_f=None, idx_h=None, generator=None):
    """Full two-view bootstrap from matched undistorted pixels.

    p1, p2 [N,2] matched keypoints in frames 1/2; valid [N]; K [3,3].
    idx_f [n,8] / idx_h [n,4]: RANSAC samples (drawn from ``generator`` when
    absent).  Returns a dict: success, R [3,3], t [3] (x2 = R x1 + t),
    X [N,3] (cam1 frame), good [N], n_good, used_h, score_h, score_f."""
    if idx_f is None:
        idx_f = draw_samples(valid, n_hypotheses, 8, generator)
    if idx_h is None:
        idx_h = draw_samples(valid, n_hypotheses, 4, generator)
    idx_f, idx_h = idx_f.long(), idx_h.long()

    pn1, T1 = _normalize(p1, valid)
    pn2, T2 = _normalize(p2, valid)

    # fundamental hypotheses
    F = T2.T @ _dlt_f(pn1[idx_f], pn2[idx_f]) @ T1  # denormalize: x2^T F x1
    sF, inlF = _score_f(F, p1, p2, valid, sigma)
    bF = torch.argmax(sF)
    score_f_best, F_best, inl_f = sF[bF], F[bF], inlF[bF]

    # homography hypotheses
    Hh = torch.linalg.inv(T2) @ _dlt_h(pn1[idx_h], pn2[idx_h]) @ T1
    sH, inlH = _score_h(Hh, p1, p2, valid, sigma)
    bH = torch.argmax(sH)
    score_h_best, H_best, inl_h = sH[bH], Hh[bH], inlH[bH]

    use_h = score_h_best / torch.clamp(score_h_best + score_f_best, min=1e-12) > 0.40

    # motion candidates: 4 from E, 8 from H; all 12 checked, gated by model
    E = K.T @ F_best @ K
    R1, R2, tE = _decompose_e(E)
    RF = torch.stack([R1, R1, R2, R2])
    tF = torch.stack([tE, -tE, tE, -tE])
    RH, tH = _decompose_h(H_best, K)
    R_all = torch.cat([RF, RH])
    t_all = torch.cat([tF, tH])
    from_h = torch.arange(12, device=p1.device) >= 4
    cand_valid = torch.where(use_h, from_h, ~from_h)
    inl = torch.where(use_h, inl_h, inl_f)

    n_good, good_mask, Xs, par = _check_rt(R_all, t_all, p1, p2, inl, K, sigma * sigma)
    n_good = torch.where(cand_valid, n_good, -1)
    best = torch.argmax(n_good)
    max_good = n_good[best]

    n_inl = torch.sum(inl)
    n_min_good = torch.clamp((0.9 * n_inl).to(torch.int64), min=min_triangulated)
    # another candidate with a comparable count is a competing reconstruction
    # only if it also has observable parallax
    n_similar = torch.sum((n_good > 0.7 * max_good) & (par > min_parallax_deg))
    success = (max_good >= n_min_good) & (n_similar == 1) & (par[best] > min_parallax_deg)
    return {
        "success": success,
        "R": R_all[best],
        "t": t_all[best],
        "X": Xs[best],
        "good": good_mask[best],
        "n_good": max_good,
        "used_h": use_h,
        "score_h": score_h_best,
        "score_f": score_f_best,
    }
