"""The matching kernel: masked Hamming best-2, CUDA on the card, plain on the CPU.

``hamming_top2`` replaces the Pallas TPU kernel of the same name
(``ccm_slam_tpu/ops/pallas_kernels.py``: ``hamming_top2`` :97, pallas_call
:121).  For each query descriptor it returns the index of the best valid
target, the best distance and the second-best distance, with the reference's
rules (``hamming_top2_reference`` :153): the lowest index wins ties; the
second-best is the minimum over every other target; invalid targets never
win; invalid queries get idx 0 and BIG; fewer than two valid targets leave
``second`` at BIG.

The kernel is hand-written CUDA C++ (``csrc/hamming_kernels.cu``, built by
``_build`` on first use, bound with ctypes): one launch, the distances on
the tensor cores' 1-bit product (popc(q & t) of 16 x 8 (query, target)
tiles, d = popc(q) + popc(t) - 2 popc(q & t)), the best-2 kept as packed
(distance, index) keys under integer min/max, the ``SLICES`` target slices
of each 32-query group merged in a thread-block cluster.
``hamming_top2_plain`` beside it is the same function in PyTorch
(``hamming_cross``'s +-1 product, argmin, masked min).  The wrapper takes
the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches (plain calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_tensor, on_card
from .hamming import best2, hamming_cross

BIG = 1 << 30  # the reference's "none" distance (after its clip)

LAUNCHES = {"hamming_top2": 0}

SLICES = 8                   # blocks of a thread-block cluster, one target slice each
MAX_SLICE = (1 << 21) - 8    # targets a slice-local key can index
MAX_TARGETS = SLICES * MAX_SLICE
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ccm_hamming_top2": [_P] * 4 + [_I] * 3 + [_P] * 4}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def slice_targets(T: int) -> int:
    """Targets per slice of the kernel: T over ``SLICES``, rounded up to a
    multiple of 8 (one MMA tile of targets); the last slices may be short
    or empty."""
    return -(-(-(-T // SLICES)) // 8) * 8


def hamming_top2_plain(q_desc, q_valid, t_desc, t_valid):
    """Plain ``hamming_top2`` (the reference's ``hamming_top2_reference``)."""
    d = hamming_cross(q_desc, t_desc)
    d = torch.where(q_valid[:, None] & t_valid[None, :], d, BIG)
    idx, best, second = best2(d, BIG)
    return idx.to(torch.int32), best, second


def hamming_top2(q_desc, q_valid, t_desc, t_valid):
    """(idx [Q], best [Q], second [Q]) int32: masked Hamming best-2 per query.

    q_desc [Q,32] uint8, q_valid [Q] bool, t_desc [T,32] uint8, t_valid [T]
    bool, all on one device; 1 <= T <= ``MAX_TARGETS``."""
    dev = q_desc.device
    Q, T = q_desc.shape[0], t_desc.shape[0]
    check_tensor("q_desc", q_desc, torch.uint8, (Q, 32), dev)
    check_tensor("q_valid", q_valid, torch.bool, (Q,), dev)
    check_tensor("t_desc", t_desc, torch.uint8, (T, 32), dev)
    check_tensor("t_valid", t_valid, torch.bool, (T,), dev)
    if not 1 <= T <= MAX_TARGETS:
        raise ValueError(f"t_desc: {T} targets, need 1 to {MAX_TARGETS}")
    if not on_card(dev):
        return hamming_top2_plain(q_desc, q_valid, t_desc, t_valid)
    i32 = dict(dtype=torch.int32, device=dev)
    idx, best, second = (torch.empty(Q, **i32) for _ in range(3))
    if Q == 0:
        return idx, best, second
    # the uint8 rows viewed as 8 words each (zero-copy)
    q_words, t_words = q_desc.view(torch.int32), t_desc.view(torch.int32)
    _build.launch(_build.load("hamming_kernels", _SIGNATURES), "ccm_hamming_top2", dev,
                  q_words.data_ptr(), q_valid.data_ptr(), t_words.data_ptr(),
                  t_valid.data_ptr(), Q, T, slice_targets(T), idx.data_ptr(), best.data_ptr(),
                  second.data_ptr())
    LAUNCHES["hamming_top2"] += 1
    return idx, best, second
