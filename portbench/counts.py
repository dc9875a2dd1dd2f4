"""Bytes and operations of the BA kernels per call, and the H100's peaks.

A frozen copy of the counts of the program's ``tools/kernel_timing.py``:
each input read once and each output written once, from the shapes and
types of the call (float32 4 bytes, int32 4, bool 1), and floating
operations per observation slot (E = P * K).  A call's bound is the larger
of its bytes over the HBM rate and its operations over the float32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores, published

# the __global__ functions of the program's csrc/ba_kernels.cu
BA_KERNEL_NAMES = (
    "reproj_cost_kernel", "sum_partials_kernel", "normal_blocks_point_kernel",
    "normal_blocks_camera_kernel", "normal_blocks_finish_kernel", "schur_point_kernel",
    "cam_broadcast_kernel", "cam_broadcast_any_kernel", "cam_reduce_kernel",
    "cam_reduce_combine_kernel", "schur_off_combine_kernel",
)


COUNTED = ("reproj_cost", "normal_blocks", "schur_off", "schur_rhs", "schur_wtv",
           "cam_broadcast")  # the wrappers that ba_solve launches


def _problem_bytes(C, P, K):
    """R, t, X, point_valid, cam_idx, uv, sigma2, obs_valid."""
    E = P * K
    return 4 * (9 * C + 3 * C + 3 * P) + P + 4 * E + 8 * E + 4 * E + E


def call_counts(name, C, P, K):
    """(bytes, operations) of one call of the wrapper ``name``."""
    E = P * K
    intr, scalar = 16, 4
    if name == "reproj_cost":
        return _problem_bytes(C, P, K) + intr + scalar, 40 * E
    if name == "normal_blocks":
        out = 4 * (18 * E + 9 * P + 3 * P + 36 * C + 6 * C) + scalar
        return _problem_bytes(C, P, K) + C + intr + out, 400 * E
    if name == "schur_off":
        return 4 * (6 * C + 18 * E + 9 * P + E + 6 * C), 80 * E
    if name == "schur_rhs":
        return 4 * (3 * P + 18 * E + E + 6 * C), 36 * E
    if name == "schur_wtv":
        return 4 * (6 * C + 18 * E + E + 3 * P), 36 * E
    if name == "cam_broadcast":  # ba_solve's final statistics: the poses, F = 12
        return 4 * (12 * C + E + 12 * E), 0
    raise KeyError(name)


def bound_s(n_bytes, n_ops):
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S)


def launches_bound_s(launches, C, P, K):
    """Summed bound seconds of the wrapper launches {name: count} on one
    problem shape (wrappers without counts here are left out)."""
    total = 0.0
    for name, n in launches.items():
        if n and name in COUNTED:
            total += n * bound_s(*call_counts(name, C, P, K))
    return total
