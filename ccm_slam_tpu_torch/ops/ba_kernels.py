"""The bundle-adjustment kernels: CUDA on the card, plain PyTorch on the CPU.

Four kernel families carry ``solvers.ba.ba_solve``; with the last two below
(the GBA profiling path, ``profile_gba``) each replaces a Pallas TPU kernel of
``ccm_slam_tpu/ops/pallas_kernels.py``:

  reproj_cost        <- fused_reproj_cost     Huber reprojection cost (scalar)
  normal_blocks      <- fused_normal_blocks   U, V, W, g_c, g_p and the cost
  schur_ops          <- make_schur_ops        (off, rhs, wtv) Schur operators
  cam_broadcast      <- cam_broadcast         camera rows -> observation rows
  cam_reduce         <- cam_reduce            observation rows -> camera sums
  make_schur_matvec  <- make_schur_matvec     the fused off-diagonal matvec

The kernels are hand-written CUDA C++ (``csrc/ba_kernels.cu``, built by
``_build`` on first use, bound with ctypes).  Beside each wrapper sits its
plain version (``*_plain``), the same function in PyTorch, mirroring the
reference's XLA form.  A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.

The interface is unpacked: W is [P,K,6,3]; U, V, g_c, g_p and the cost are
plain tensors.  Camera sums on the card go through a ``CamCSR`` (observations
stably sorted by camera), built once per solve with ``cam_csr``; ``cam_reduce``
through a ``ReduceCSR`` (``reduce_csr``), which drops out-of-range ids.

``LAUNCHES`` counts kernel launches per wrapper (plain calls do not count),
so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..solvers import reproj
from . import _build
from ._build import check_tensor as _check, on_card as _on_card

LAUNCHES = {
    "reproj_cost": 0,
    "normal_blocks": 0,
    "schur_off": 0,
    "schur_rhs": 0,
    "schur_wtv": 0,
    "cam_broadcast": 0,
    "cam_reduce": 0,
    "schur_matvec": 0,
}

_THREADS = 256  # block size of csrc/ba_kernels.cu's per-observation kernels
_ROW_F = 42     # a camera's U (36) + g_c (6) row
CHUNK = 512     # CSR slots per block of the camera-major kernels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ccm_reproj_cost": [_P] * 9 + [_I] * 5 + [_F] + [_P] * 3,
    "ccm_normal_blocks": [_P] * 10 + [_I] * 6 + [_F] + [_P] * 11,
    "ccm_schur_off": [_P] * 7 + [_I] * 6 + [_P] * 4,
    "ccm_schur_rhs": [_P] * 5 + [_I] * 6 + [_P] * 4,
    "ccm_schur_wtv": [_P] * 3 + [_I] * 5 + [_P] * 2,
    "ccm_cam_broadcast": [_P] * 2 + [_I, _I, _I] + [_P] * 2,
    "ccm_cam_reduce": [_P] * 4 + [_I] * 4 + [_P] * 3,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(_build.load("ba_kernels", _SIGNATURES), name, device, *args)


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _check_problem(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, intr):
    """Validate the observation tables; returns (C, P, K, device)."""
    dev = R.device
    C = R.shape[0]
    if cam_idx.dim() != 2:
        raise ValueError(f"cam_idx: expected [P,K], got {tuple(cam_idx.shape)}")
    P, K = cam_idx.shape
    f32 = torch.float32
    _check("R", R, f32, (C, 3, 3), dev)
    _check("t", t, f32, (C, 3), dev)
    _check("X", X, f32, (P, 3), dev)
    _check("point_valid", point_valid, torch.bool, (P,), dev)
    _check("cam_idx", cam_idx, torch.int32, (P, K), dev)
    _check("uv", uv, f32, (P, K, 2), dev)
    _check("sigma2", sigma2, f32, (P, K), dev)
    _check("obs_valid", obs_valid, torch.bool, (P, K), dev)
    _check("intr", intr, f32, (4,), dev)
    if C == 0:
        raise ValueError("R: need at least one camera")
    return C, P, K, dev


# ---------------------------------------------------------------------------
# Camera CSR: observations grouped by camera, once per solve.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CamCSR:
    """Observations stably sorted by (clipped) camera index.

    cam_idx is constant across LM and CG iterations, so this is built once
    per solve.  Camera c owns sorted slots ``offsets[c]:offsets[c+1]``;
    ``order[j]`` is the observation in slot j.  ``normal_blocks``' camera
    kernel and ``schur_ops``' off and rhs read the observations of each
    camera through ``order``, one block per chunk of ``CHUNK`` slots (camera
    c owns chunks ``chunks[c]:chunks[c+1]``).
    """

    C: int
    ci: torch.Tensor       # [P,K] int32, cam_idx clipped to [0, C)
    offsets: torch.Tensor  # [C+1] int32
    order: torch.Tensor    # [P*K] int32
    chunks: torch.Tensor   # [C+1] int32


def _sorted_slots(key: torch.Tensor, C: int):
    """(order, offsets, chunks) of ``key`` [E] int64 in [0, C]: a stable
    sort by key; slots of key C (a drop bucket) come last and own no offsets
    or chunks."""
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=C + 1)[:C]
    offsets = torch.zeros(C + 1, dtype=torch.int64, device=key.device)
    offsets[1:] = torch.cumsum(counts, 0)
    chunks = torch.zeros_like(offsets)
    chunks[1:] = torch.cumsum((counts + CHUNK - 1) // CHUNK, 0)
    i32 = torch.int32
    return order.to(i32), offsets.to(i32), chunks.to(i32)


def cam_csr(cam_idx: torch.Tensor, C: int) -> CamCSR:
    ci = cam_idx.clamp(0, C - 1).to(torch.int32).contiguous()
    order, offsets, chunks = _sorted_slots(ci.reshape(-1).long(), C)
    return CamCSR(C=C, ci=ci, offsets=offsets, order=order, chunks=chunks)


@dataclass(frozen=True)
class ReduceCSR:
    """Rows grouped by camera for ``cam_reduce``: rows whose id lies outside
    [0, C) are DROPPED (sorted into a trailing bucket, slots ``offsets[C]``
    and after, that is never read), unlike ``cam_csr``, which clamps ids for
    BA.  Camera c owns sorted slots ``offsets[c]:offsets[c+1]`` and chunks
    ``chunks[c]:chunks[c+1]`` of ``CHUNK`` slots; ``order[j]`` is the row in
    slot j; ``offsets[C]`` is the number of rows kept."""

    C: int
    offsets: torch.Tensor  # [C+1] int32
    order: torch.Tensor    # [E] int32
    chunks: torch.Tensor   # [C+1] int32


def reduce_csr(ci: torch.Tensor, C: int) -> ReduceCSR:
    key = torch.where((ci >= 0) & (ci < C), ci, C).long()
    order, offsets, chunks = _sorted_slots(key, C)
    return ReduceCSR(C=C, offsets=offsets, order=order, chunks=chunks)


def _check_csr(csr: CamCSR, C: int, P: int, K: int, device) -> None:
    if csr.C != C:
        raise ValueError(f"csr built for C={csr.C}, problem has C={C}")
    _check("csr.ci", csr.ci, torch.int32, (P, K), device)
    _check("csr.offsets", csr.offsets, torch.int32, (C + 1,), device)
    _check("csr.order", csr.order, torch.int32, (P * K,), device)
    _check("csr.chunks", csr.chunks, torch.int32, (C + 1,), device)


# ---------------------------------------------------------------------------
# Plain versions (the reference's XLA forms, in PyTorch).
# ---------------------------------------------------------------------------


def reproj_cost_plain(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, intr,
                      huber_delta):
    """Plain ``reproj_cost`` (the reference's ``ba._cost``)."""
    ci = cam_idx.clamp(0, R.shape[0] - 1).long()
    _, _, _, chi2, _ = reproj.obs_residuals(
        R[ci], t[ci], X, point_valid, uv, sigma2, obs_valid, intr, huber_delta
    )
    return torch.sum(reproj.huber_rho(chi2, huber_delta))


def normal_blocks_plain(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, cam_fixed,
                        intr, huber_delta):
    """Plain ``normal_blocks`` (the reference's ``ba._build_normal_blocks``
    with ``trans=None``, plus ``ba._cost``)."""
    C = R.shape[0]
    ci = cam_idx.clamp(0, C - 1).long()
    Rc = R[ci]
    r, Xc, w, chi2, _ = reproj.obs_residuals(
        Rc, t[ci], X, point_valid, uv, sigma2, obs_valid, intr, huber_delta
    )
    Jc, Jp = reproj.pose_point_jacobians(Rc, Xc, intr[0], intr[1])
    gate = (w > 0)[..., None, None]
    # fixed cameras contribute no pose Jacobian but still constrain the point
    cam_var = (~cam_fixed)[ci][..., None, None].to(r.dtype)
    Jc = Jc * gate * cam_var
    Jp = Jp * gate
    wJc = Jc * w[..., None, None]
    wJp = Jp * w[..., None, None]

    V = torch.einsum("pkij,pkil->pjl", wJp, Jp)   # [P,3,3]
    W = torch.einsum("pkij,pkil->pkjl", wJc, Jp)  # [P,K,6,3]
    g_p = -torch.einsum("pkij,pki->pj", wJp, r)   # [P,3]
    U_blk = torch.einsum("pkij,pkil->pkjl", wJc, Jc)  # [P,K,6,6]
    g_blk = -torch.einsum("pkij,pki->pkj", wJc, r)    # [P,K,6]
    flat = ci.reshape(-1)
    U = torch.zeros(C, 6, 6, dtype=r.dtype, device=r.device).index_add_(
        0, flat, U_blk.reshape(-1, 6, 6)
    )
    g_c = torch.zeros(C, 6, dtype=r.dtype, device=r.device).index_add_(
        0, flat, g_blk.reshape(-1, 6)
    )
    cost = torch.sum(reproj.huber_rho(chi2, huber_delta))
    return U, V.contiguous(), W.contiguous(), g_c, g_p.contiguous(), cost


def schur_ops_plain(W, Vinv, cam_idx, C: int):
    """Plain ``schur_ops`` (the reference's ``schur_matvec_reference``,
    ``schur_rhs_reference`` and ``schur_wtv_reference``)."""
    ci = cam_idx.clamp(0, C - 1).long()
    flat = ci.reshape(-1)

    def cam_sum(y3):
        out = torch.zeros(C, 6, dtype=y3.dtype, device=y3.device)
        return out.index_add_(0, flat, y3.reshape(-1, 6))

    def off(v):
        y1 = torch.einsum("pkij,pki->pkj", W, v[ci])
        y2 = torch.einsum("pij,pj->pi", Vinv, torch.sum(y1, dim=1))
        return cam_sum(torch.einsum("pkij,pj->pki", W, y2))

    def rhs(q):
        return cam_sum(torch.einsum("pkij,pj->pki", W, q))

    def wtv(v):
        return torch.einsum("pkij,pki->pj", W, v[ci])

    return off, rhs, wtv


def cam_broadcast_plain(v, ci):
    """Plain ``cam_broadcast`` (the reference's ``cam_broadcast_reference``)."""
    C = v.shape[0]
    ok = (ci >= 0) & (ci < C)
    return torch.where(ok[:, None], v[ci.clamp(0, C - 1).long()], 0.0)


def cam_reduce_plain(y, ci, C: int):
    """Plain ``cam_reduce`` (the reference's ``cam_reduce_reference``: a
    masked segment sum, as ``index_add_``)."""
    ok = (ci >= 0) & (ci < C)
    out = torch.zeros(C, y.shape[1], dtype=y.dtype, device=y.device)
    return out.index_add_(0, torch.where(ok, ci, 0).long(), torch.where(ok[:, None], y, 0.0))


def schur_matvec_plain(W, Vinv, cam_idx, C: int):
    """Plain ``make_schur_matvec`` (the reference's ``schur_matvec_reference``)."""
    return schur_ops_plain(W, Vinv, cam_idx, C)[0]


# ---------------------------------------------------------------------------
# Wrappers: kernel on the card, plain version on the CPU.
# ---------------------------------------------------------------------------


def _chunk_rows(E: int, C: int) -> int:
    """Rows of the camera-major kernels' per-chunk scratch: the chunks of
    ``CHUNK`` slots number at most E // CHUNK + C."""
    return E // CHUNK + C


def point_layout(K: int) -> tuple:
    """(threads, L) of the per-observation kernels (``normal_blocks``' point
    kernel, ``reproj_cost``, ``schur_ops``): blocks of ``threads`` (256,
    or the power of two at or above K) holding L = threads // K whole
    landmarks, one thread per observation slot."""
    if not 1 <= K <= 1024:
        raise ValueError(f"K={K} observation slots; the card's kernels take 1 to 1024")
    threads = _THREADS if K <= _THREADS else 1 << (K - 1).bit_length()
    return threads, threads // K


def reproj_cost(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, intr,
                huber_delta: float):
    """Huber reprojection cost of the state (0-d float32 tensor).

    Observations with an invalid flag, an invalid point or depth <= 1e-6
    contribute 0; cam_idx is clipped to [0, C)."""
    C, P, K, dev = _check_problem(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, intr)
    if not _on_card(dev):
        return reproj_cost_plain(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid,
                                 intr, huber_delta)
    threads, L = point_layout(K)
    partials = torch.empty(max(1, -(-P // L)), dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    _launch("ccm_reproj_cost", dev, _ptr(R), _ptr(t), _ptr(X), _ptr(point_valid),
            _ptr(cam_idx), _ptr(uv), _ptr(sigma2), _ptr(obs_valid), _ptr(intr),
            C, P, K, threads, L, float(huber_delta), _ptr(partials), _ptr(cost))
    LAUNCHES["reproj_cost"] += 1
    return cost


def normal_blocks(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, cam_fixed, intr,
                  huber_delta: float, csr: CamCSR):
    """Normal-equation blocks of the state in one pass over the observations.

    Returns (U [C,6,6], V [P,3,3], W [P,K,6,3], g_c [C,6], g_p [P,3], cost):
    U = sum_cam w Jc^T Jc, g_c = -sum_cam w Jc^T r, V = sum_k w Jp^T Jp,
    g_p = -sum_k w Jp^T r, W = w Jc^T Jp per observation (Huber IRLS w; pose
    Jacobians zero for fixed cameras), and the Huber cost."""
    C, P, K, dev = _check_problem(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid, intr)
    _check("cam_fixed", cam_fixed, torch.bool, (C,), dev)
    _check_csr(csr, C, P, K, dev)
    if not _on_card(dev):
        return normal_blocks_plain(R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid,
                                   cam_fixed, intr, huber_delta)
    threads, L = point_layout(K)
    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.empty(P, K, 6, 3, **f32)
    V = torch.empty(P, 3, 3, **f32)
    g_p = torch.empty(P, 3, **f32)
    UG = torch.empty(C, _ROW_F, **f32)
    cam_part = torch.empty(_chunk_rows(P * K, C), _ROW_F, **f32)
    partials = torch.empty(max(1, -(-P // L)), **f32)
    cost = torch.empty((), **f32)
    _launch("ccm_normal_blocks", dev, _ptr(R), _ptr(t), _ptr(X), _ptr(point_valid),
            _ptr(cam_idx), _ptr(uv), _ptr(sigma2), _ptr(obs_valid), _ptr(cam_fixed),
            _ptr(intr), C, P, K, threads, L, CHUNK, float(huber_delta), _ptr(csr.order),
            _ptr(csr.offsets), _ptr(csr.chunks), _ptr(W), _ptr(V), _ptr(g_p), _ptr(UG),
            _ptr(cam_part), _ptr(partials), _ptr(cost))
    LAUNCHES["normal_blocks"] += 1
    return UG[:, :36].reshape(C, 6, 6), V, W, UG[:, 36:], g_p, cost


def _check_schur(W, Vinv, csr: CamCSR):
    """Validate the Schur operands; returns (P, K, device)."""
    dev = W.device
    if W.dim() != 4:
        raise ValueError(f"W: expected [P,K,6,3], got {tuple(W.shape)}")
    P, K = W.shape[:2]
    _check("W", W, torch.float32, (P, K, 6, 3), dev)
    _check("Vinv", Vinv, torch.float32, (P, 3, 3), dev)
    _check_csr(csr, csr.C, P, K, dev)
    return P, K, dev


def _cam_scratch(E: int, C: int, device):
    """Scratch of the Schur kernels' camera side: per-observation rows y3
    [E,6] and per-chunk sums.  An operator allocates it once; its calls run
    in stream order, so off and rhs can share it."""
    f32 = dict(dtype=torch.float32, device=device)
    return torch.empty(E, 6, **f32), torch.empty(_chunk_rows(E, C), 6, **f32)


def _schur_off(W, Vinv, csr: CamCSR, counter: str, scratch):
    """``off`` on the card: ccm_schur_off, counted under ``counter``, its
    rows and chunk sums in ``scratch`` (``_cam_scratch``)."""
    P, K, dev = _check_schur(W, Vinv, csr)
    C = csr.C
    threads, L = point_layout(K)
    y3, part = scratch

    def off(v):
        _check("v", v, torch.float32, (C, 6), dev)
        out = torch.empty(C, 6, dtype=torch.float32, device=dev)
        _launch("ccm_schur_off", dev, _ptr(v), _ptr(W), _ptr(Vinv), _ptr(csr.ci),
                _ptr(csr.order), _ptr(csr.offsets), _ptr(csr.chunks), C, P, K, threads, L,
                CHUNK, _ptr(y3), _ptr(part), _ptr(out))
        LAUNCHES[counter] += 1
        return out

    return off


def schur_ops(W, Vinv, csr: CamCSR):
    """The three Schur-stage operators over W [P,K,6,3]:

      off(v [C,6]) -> [C,6]  sum_e W_e Vinv_p sum_{e' in p} W_e'^T v[ci_e']
      rhs(q [P,3]) -> [C,6]  camera sums of W_e q_p
      wtv(v [C,6]) -> [P,3]  landmark sums of W_e^T v[ci_e]

    with ci = csr.ci (cam_idx clipped to [0, C)).  On the card all three
    run one thread per observation (``point_layout``); off and rhs sum
    their per-observation rows per camera through ``csr.order``."""
    P, K, dev = _check_schur(W, Vinv, csr)
    C = csr.C
    if not _on_card(dev):
        return schur_ops_plain(W, Vinv, csr.ci, C)
    threads, L = point_layout(K)
    scratch = _cam_scratch(P * K, C, dev)
    y3, part = scratch
    off = _schur_off(W, Vinv, csr, "schur_off", scratch)

    def rhs(q):
        _check("q", q, torch.float32, (P, 3), dev)
        out = torch.empty(C, 6, dtype=torch.float32, device=dev)
        _launch("ccm_schur_rhs", dev, _ptr(q), _ptr(W), _ptr(csr.order), _ptr(csr.offsets),
                _ptr(csr.chunks), C, P, K, threads, L, CHUNK, _ptr(y3), _ptr(part), _ptr(out))
        LAUNCHES["schur_rhs"] += 1
        return out

    def wtv(v):
        _check("v", v, torch.float32, (C, 6), dev)
        out = torch.empty(P, 3, dtype=torch.float32, device=dev)
        _launch("ccm_schur_wtv", dev, _ptr(v), _ptr(W), _ptr(csr.ci), C, P, K, threads, L,
                _ptr(out))
        LAUNCHES["schur_wtv"] += 1
        return out

    return off, rhs, wtv


def cam_broadcast(v, ci):
    """Camera rows to observation rows: out[e] = v[ci[e]], zeros where ci is
    outside [0, C).  v [C,F] float32, ci [E] int32 -> [E,F]."""
    dev = v.device
    if v.dim() != 2 or ci.dim() != 1:
        raise ValueError(f"expected v [C,F] and ci [E], got {tuple(v.shape)}, {tuple(ci.shape)}")
    C, F = v.shape
    E = ci.shape[0]
    _check("v", v, torch.float32, (C, F), dev)
    _check("ci", ci, torch.int32, (E,), dev)
    if not _on_card(dev):
        return cam_broadcast_plain(v, ci)
    out = torch.empty(E, F, dtype=torch.float32, device=dev)
    _launch("ccm_cam_broadcast", dev, _ptr(v), _ptr(ci), C, F, E, _ptr(out))
    LAUNCHES["cam_broadcast"] += 1
    return out


def cam_reduce(y, ci, C: int, csr: ReduceCSR = None):
    """Observation rows to camera sums: out[c] = sum_{e: ci[e]=c} y[e]; rows
    whose id lies outside [0, C) are dropped.  y [E,F] float32, ci [E] int32
    -> [C,F].  ``csr`` (``reduce_csr(ci, C)``) may be passed in when ci is
    reused across calls.  On the card one pass gathers each camera's rows
    through ``csr.order`` and sums them in a fixed order (no atomics)."""
    dev = y.device
    if y.dim() != 2 or ci.dim() != 1:
        raise ValueError(f"expected y [E,F] and ci [E], got {tuple(y.shape)}, {tuple(ci.shape)}")
    E, F = y.shape
    _check("y", y, torch.float32, (E, F), dev)
    _check("ci", ci, torch.int32, (E,), dev)
    if C <= 0:
        raise ValueError("cam_reduce: need at least one camera")
    if not _on_card(dev):
        return cam_reduce_plain(y, ci, C)
    csr = reduce_csr(ci, C) if csr is None else csr
    if csr.C != C:
        raise ValueError(f"csr built for C={csr.C}, call has C={C}")
    _check("csr.order", csr.order, torch.int32, (E,), dev)
    _check("csr.offsets", csr.offsets, torch.int32, (C + 1,), dev)
    _check("csr.chunks", csr.chunks, torch.int32, (C + 1,), dev)
    part = torch.empty(_chunk_rows(E, C), F, dtype=torch.float32, device=dev)
    out = torch.empty(C, F, dtype=torch.float32, device=dev)
    _launch("ccm_cam_reduce", dev, _ptr(y), _ptr(csr.order), _ptr(csr.offsets),
            _ptr(csr.chunks), C, F, E, CHUNK, _ptr(part), _ptr(out))
    LAUNCHES["cam_reduce"] += 1
    return out


def make_schur_matvec(W, Vinv, cam_idx, C: int):
    """The fused off-diagonal Schur matvec, ``off(v [C,6]) -> [C,6]`` =
    sum_e W_e Vinv_p(e) sum_{e' in p(e)} W_e'^T v[ci_e'], with cam_idx
    [P,K] clipped to [0, C) as the reference clips it.

    Counterpart of ``pallas_kernels.make_schur_matvec``.  That function's
    pallas_call runs the same kernel body (``_schur_matvec_kernel``) as
    ``make_schur_ops``' off, so here it launches the same CUDA kernel as
    ``schur_ops``' off (``ccm_schur_off``), counted under its own key
    ``LAUNCHES["schur_matvec"]``.  The camera CSR is built once, here."""
    csr = cam_csr(cam_idx, C)
    _check_schur(W, Vinv, csr)
    if not _on_card(W.device):
        return schur_matvec_plain(W, Vinv, csr.ci, C)
    return _schur_off(W, Vinv, csr, "schur_matvec", _cam_scratch(csr.ci.numel(), C, W.device))
