"""The arithmetic of ``hamming_top2``'s tensor-core kernel, on the CPU.

``csrc/hamming_kernels.cu`` turns each (query, target) pair into a 32-bit
key ((popc(t) + 256 - 2 popc(q & t)) << 21 | slice-local index), keeps the
best two keys of each query under integer min/max (any order), widens them
to (d << 32 | global index) per slice and merges the 8 slices the same way.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here a numpy model of those steps, fed the keys in a shuffled order, must
give the plain version's and the JAX reference's outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.ops import pallas_kernels as pk
from ccm_slam_tpu_torch.ops import hamming_kernels as hk

IDX_BITS = 21
INVALID_POPC = 1024
NONE = np.uint64(2**64 - 1)
BIG = 1 << 30


def popcount(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)


def best2(keys):
    """The kernel's best-2 of unique uint32 keys, pushed in the given order."""
    best = second = np.uint32(2**32 - 1)
    for k in keys:
        second = min(second, max(best, k))
        best = min(best, k)
    return best, second


def merge(a, b):
    return min(a[0], b[0]), min(min(a[1], b[1]), max(a[0], b[0]))


def kernel_model(q, qv, t, tv, seed):
    """(idx, best, second) as the kernel computes them."""
    Q, T = q.shape[0], t.shape[0]
    chunk = hk.slice_targets(T)
    pq, pt = popcount(q), popcount(t)
    both = popcount(q[:, None, :] & t[None, :, :])  # [Q, T]
    rng = np.random.default_rng(seed)
    out = np.zeros((3, Q), np.int64)
    for i in range(Q):
        total = (NONE, NONE)
        for s in rng.permutation(hk.SLICES):  # slice merge order does not matter
            lo, hi = s * chunk, min(T, (s + 1) * chunk)
            j = np.arange(lo, hi)
            field = np.where(tv[lo:hi], pt[lo:hi], INVALID_POPC) + 256 - 2 * both[i, lo:hi]
            assert np.all((field >= 0) & (field < 2**11))  # fits its 11 bits
            keys = (field.astype(np.uint32) << IDX_BITS) | (j - lo).astype(np.uint32)
            b, sec = best2(keys[rng.permutation(len(keys))])

            def widen(k):
                f = int(k) >> IDX_BITS
                if f > 512:
                    return NONE
                idx = lo + (int(k) & (2**IDX_BITS - 1))
                return np.uint64(((f - 256 + int(pq[i])) << 32) | idx)

            total = merge(total, (widen(b), widen(sec)))
        b, sec = total
        if qv[i] and b != NONE:
            out[0, i], out[1, i] = int(b) & 0xFFFFFFFF, int(b) >> 32
        else:
            out[0, i], out[1, i] = 0, BIG
        out[2, i] = int(sec) >> 32 if qv[i] and sec != NONE else BIG
    return out


def case(name):
    """Small counterparts of the card test's cases: ties inside a tile,
    across tiles and across slices, a tie whose lower target is invalid."""
    rng = np.random.default_rng(3)
    Q, T = 21, 203
    q = rng.integers(0, 256, (Q, 32), dtype=np.uint8)
    t = rng.integers(0, 256, (T, 32), dtype=np.uint8)
    qv = np.ones(Q, bool)
    tv = rng.random(T) >= 0.25
    s = hk.slice_targets(T)
    for i, (a, b) in enumerate([(3, 5), (7, 8), (s - 1, s), (T - 2, T - 1), (11, 12)]):
        t[b] = t[a]
        q[i] = t[a]
        q[i, i] ^= 1
        tv[a] = tv[b] = True
    tv[11] = False
    if name == "all_equal":
        t[:] = t[0]
    if name == "no_valid_target":
        tv[:] = False
    if name == "invalid_queries":
        qv[::3] = False
    if name == "one_valid_target":
        tv[:] = False
        tv[T - 7] = True
    return q, qv, t, tv


@pytest.mark.parametrize("name", ["ragged_ties", "all_equal", "no_valid_target",
                                  "invalid_queries", "one_valid_target"])
def test_kernel_keys_match_plain_and_reference(name):
    q, qv, t, tv = case(name)
    ours = kernel_model(q, qv, t, tv, seed=len(name))
    plain = hk.hamming_top2_plain(*(torch.as_tensor(x) for x in (q, qv, t, tv)))
    ref = jax.jit(pk.hamming_top2_reference)(*(jnp.asarray(x) for x in (q, qv, t, tv)))
    for k in range(3):
        np.testing.assert_array_equal(ours[k], plain[k].numpy())
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))
    if name == "ragged_ties":
        assert list(ours[0, :5]) == [3, 7, 31, 201, 12]
        assert list(ours[1, :5]) == [1] * 5 and list(ours[2, :4]) == [1] * 4
