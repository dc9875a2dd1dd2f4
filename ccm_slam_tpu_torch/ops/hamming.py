"""Batched 256-bit Hamming distance for ORB descriptors (PyTorch).

Counterpart of ``ccm_slam_tpu/ops/hamming.py``.  Descriptors are ``uint8
[N, 32]`` (256 bits, LSB-first per byte).  Paired distances are XOR +
popcount on the packed bits (as four 64-bit words).  The dense cross and
self distances are one float32 product of +-1 bit planes: exact integers
in any summation order, and on an H100 1.3-21x faster than chunked XOR +
popcount at the shapes the port calls them with
(``tools/hamming_paths.py``).  The reference's bf16 product of {0,1}
planes is not copied.

Tie rule, everywhere: among equal distances the lowest index wins (the
reference's ``jax.lax.top_k`` / ``argmin`` order), so callers that resolve
claims by index pick the same rows.
"""

from __future__ import annotations

import torch

INVALID_DIST = 256  # > max Hamming distance; masks invalid slots
TH_LOW = 50   # reference ORBmatcher.cpp:63
TH_HIGH = 100  # reference ORBmatcher.cpp:64


def unpack_bits(desc_u8):
    """uint8 [..., 32] -> bit planes [..., 256] (uint8 in {0,1}), LSB-first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[..., :, None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], desc_u8.shape[-1] * 8)


def pack_bits(bits):
    """[..., 256] {0,1} -> uint8 [..., 32]. Inverse of unpack_bits."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return torch.sum(b << shifts, dim=-1).to(torch.uint8)


def popcount64(x):
    """Per-word popcount of an int64 tensor (SWAR; the masks clear the bits
    that the arithmetic shift of a negative word brings in)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x + (x >> 32)) & 0x7F


def _words(desc_u8):
    """uint8 [..., 32] -> int64 [..., 4] (the same bits, as four words)."""
    if desc_u8.stride(-1) != 1:
        desc_u8 = desc_u8.contiguous()
    return desc_u8.view(torch.int64)


def hamming_pairwise(a_u8, b_u8):
    """Elementwise-paired distance: [..., 32] x [..., 32] -> [...] int32."""
    return torch.sum(popcount64(_words(a_u8) ^ _words(b_u8)), dim=-1, dtype=torch.int32)


def _signs(desc_u8):
    """uint8 [..., 32] -> float32 [..., 256] of +-1 (bit 1 -> -1)."""
    return unpack_bits(desc_u8).to(torch.float32).mul_(-2.0).add_(1.0)


def _sign_distance(dot):
    """Hamming distance from a dot product of +-1 planes: exact, since every
    partial sum of +-1 terms is an integer of magnitude <= 256."""
    return ((256.0 - dot) * 0.5).to(torch.int32)


def hamming_cross(query_u8, db_u8):
    """Dense cross distance: [Q, 32] x [D, 32] uint8 -> [Q, D] int32 in [0, 256]."""
    return _sign_distance(_signs(query_u8) @ _signs(db_u8).T)


def hamming_cross_popcount(query_u8, db_u8):
    """The dense cross distance by XOR + popcount of the packed words (no
    product): [Q, 32] x [D, 32] uint8 -> [Q, D] int32; the golden version
    for tests."""
    x = _words(query_u8)[:, None, :] ^ _words(db_u8)[None, :, :]
    return torch.sum(popcount64(x), dim=-1, dtype=torch.int32)


def hamming_self(desc_u8):
    """Distances among each row's descriptors: [B, O, 32] -> [B, O, O] int32."""
    s = _signs(desc_u8)
    return _sign_distance(s @ s.transpose(1, 2))


def masked_hamming_cross(query_u8, query_valid, db_u8, db_valid):
    """Cross distance with invalid slots pushed to INVALID_DIST."""
    d = hamming_cross(query_u8, db_u8)
    mask = query_valid[:, None] & db_valid[None, :]
    return torch.where(mask, d, INVALID_DIST)


def best2(dist, big: int):
    """(best_idx, best, second) along the last axis of an integer distance
    matrix: the lowest index of the minimum, the minimum, and the minimum over
    every other column (equal to the best when the minimum occurs twice;
    ``big`` when there is no other column)."""
    idx = torch.argmin(dist, dim=-1)
    best = torch.gather(dist, -1, idx[..., None])[..., 0]
    rest = dist.scatter(-1, idx[..., None], big)
    second = torch.amin(rest, dim=-1) if dist.shape[-1] > 1 else torch.full_like(best, big)
    return idx, best, second


def best_match(dist, axis=-1):
    """(best_idx, best_dist, second_dist) along ``axis`` of a distance matrix
    (the bestDist/bestDist2 pattern of ORBmatcher, e.g. ORBmatcher.cpp:497-540)."""
    d = torch.movedim(dist, axis, -1)
    return best2(d, torch.iinfo(d.dtype).max if not d.is_floating_point() else float("inf"))


def mutual_best(dist):
    """Mutual nearest-neighbour test on a [Q, D] distance matrix.

    Returns (match_idx [Q], valid [Q])."""
    row_best = torch.argmin(dist, dim=1)
    col_best = torch.argmin(dist, dim=0)
    mutual = col_best[row_best] == torch.arange(dist.shape[0], device=dist.device)
    return row_best, mutual


def top_k_stable(x, k: int):
    """(values, indices) of the k largest entries along the last axis, lower
    index first among equals (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def rotation_histogram_filter(angle_q, angle_t, match_valid, n_bins: int = 30, keep: int = 3):
    """Rotation-consistency filter (ORBmatcher HISTO_LENGTH=30 /
    ComputeThreeMaxima, ORBmatcher.cpp:1607-1646).

    angle_q/angle_t: per-match keypoint angles in degrees, [N].  Keeps matches
    whose angle difference falls in the ``keep`` most populated bins (bins
    2..keep only with >= 10% of bin 1's count).  Returns the filtered mask."""
    rot = angle_q - angle_t
    rot = torch.where(rot < 0.0, rot + 360.0, rot)
    factor = n_bins / 360.0
    bins = torch.round(rot * factor).to(torch.int32)
    bins = torch.where(bins == n_bins, 0, bins)
    bins = torch.clamp(bins, 0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int32, device=bins.device).index_add_(
        0, bins.long(), match_valid.to(torch.int32))
    top_counts, top_idx = top_k_stable(counts, keep)
    ranks = torch.arange(keep, device=bins.device).clamp(0, 1)
    keep_mask = top_counts >= torch.clamp((0.1 * top_counts[0]).to(torch.int32) * ranks, min=1)
    in_top = torch.any((bins[:, None] == top_idx[None, :]) & keep_mask[None, :], dim=1)
    return match_valid & in_top
