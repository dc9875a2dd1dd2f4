"""The port's Hamming ops, the plain ``hamming_top2`` and every matching
strategy against the JAX package on the CPU, on the same seeded inputs.

Everything here is integer arithmetic or a comparison of the same float32
products, so the tolerance is exact: distances and best-2 equal; for the
match functions ``ok`` equal and ``idx`` / ``best`` equal wherever ``ok``
(measured: equal everywhere).  Ties resolve to the lowest index in both
packages (``jax.lax.top_k``; a stable sort and ``argmin`` in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.ops import hamming as jh, matching as jm, pallas_kernels as pk
from ccm_slam_tpu_torch.ops import hamming as th, hamming_kernels as hk, matching as tm

T = torch.tensor
J = jnp.asarray

# the JAX side, jitted: eager JAX compiles every op on its own
j_cross = jax.jit(lambda q, d, qv, dv: (jh.hamming_cross(q, d),
                                        jh.hamming_pairwise(q[:64], d[:64]),
                                        jh.masked_hamming_cross(q, qv, d, dv)))
j_best = jax.jit(lambda d: (jh.best_match(d), jh.best_match(d, axis=0), jh.mutual_best(d)))
j_rot = jax.jit(jh.rotation_histogram_filter)
j_top2_ref = jax.jit(pk.hamming_top2_reference)
j_brute = jax.jit(jm.match_brute, static_argnames=("th_dist", "nn_ratio", "check_rotation"))
j_init = jax.jit(jm.search_for_initialization)
j_window = jax.jit(jm.match_in_window)
j_tri = jax.jit(jm.search_for_triangulation)


def rand_desc(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def perturb(rng, desc, n_bits):
    """Flip n_bits random bits of each descriptor."""
    bits = np.unpackbits(desc, axis=1, bitorder="little")
    rows = np.arange(len(desc))[:, None]
    bits[rows, rng.integers(0, 256, (len(desc), n_bits))] ^= 1
    return np.packbits(bits, axis=1, bitorder="little")


def test_pack_unpack_and_popcount():
    rng = np.random.default_rng(0)
    d = rand_desc(rng, 16)
    np.testing.assert_array_equal(th.unpack_bits(T(d)).numpy(), np.asarray(jh.unpack_bits(d)))
    np.testing.assert_array_equal(th.pack_bits(th.unpack_bits(T(d))).numpy(), d)
    x = np.concatenate([rng.integers(-2**63, 2**63 - 1, 1000, dtype=np.int64, endpoint=True),
                        np.array([0, -1, 1, -2**63, 2**63 - 1], np.int64)])
    np.testing.assert_array_equal(th.popcount64(T(x)).numpy(),
                                  np.unpackbits(x.view(np.uint8).reshape(-1, 8), 1).sum(1))


def test_hamming_cross_exact():
    rng = np.random.default_rng(1)
    q, d = rand_desc(rng, 64), rand_desc(rng, 128)
    qv, dv = np.arange(64) < 40, np.arange(128) % 3 > 0
    cross, pair, masked = (np.asarray(a) for a in j_cross(J(q), J(d), J(qv), J(dv)))
    np.testing.assert_array_equal(th.hamming_cross(T(q), T(d)).numpy(), cross)
    np.testing.assert_array_equal(th.hamming_pairwise(T(q), T(d[:64])).numpy(), pair)
    np.testing.assert_array_equal(th.masked_hamming_cross(T(q), T(qv), T(d), T(dv)).numpy(),
                                  masked)
    assert int(th.hamming_cross(T(np.zeros((1, 32), np.uint8)),
                                T(np.full((1, 32), 255, np.uint8)))[0, 0]) == 256


def test_hamming_cross_popcount_matches_jax_and_the_product():
    rng = np.random.default_rng(2)
    q, d = rand_desc(rng, 50), rand_desc(rng, 70)
    q[0], q[1], d[0], d[1] = 0, 255, 255, q[2]
    ref = np.asarray(jax.jit(jh.hamming_cross_popcount)(J(q), J(d)))
    ours = th.hamming_cross_popcount(T(q), T(d))
    assert ours.dtype == torch.int32 and ours.shape == (50, 70)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert torch.equal(ours, th.hamming_cross(T(q), T(d)))
    assert ours[0, 0] == 256 and ours[1, 0] == 0 and ours[2, 1] == 0


def test_best_match_and_mutual_with_ties():
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 6, (40, 50)).astype(np.int32)  # many ties
    rows, cols, mutual = j_best(J(dist))
    ours = (th.best_match(T(dist)), th.best_match(T(dist), axis=0), th.mutual_best(T(dist)))
    for got, ref in zip(ours, (rows, cols, mutual)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_top_k_ties_match_jax_top_k():
    """jax.lax.top_k returns the lower index first among equal values;
    torch.topk promises no order, so the port sorts stably."""
    x = np.random.default_rng(9).integers(0, 4, 200).astype(np.float32)
    vals, idx = jax.jit(lambda v: jax.lax.top_k(v, 50))(J(x))
    ours = th.top_k_stable(T(x), 50)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(vals))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(idx))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_histogram_filter_exact(seed):
    rng = np.random.default_rng(seed)
    n = 300
    # a dominant rotation plus clutter; counts tie between bins often
    a_q = rng.uniform(0, 360, n).astype(np.float32)
    rot = np.where(rng.random(n) < 0.6, 24.0, rng.integers(0, 30, n) * 12.0)
    a_t = ((a_q - rot) % 360).astype(np.float32)
    valid = rng.random(n) < 0.8
    ours = th.rotation_histogram_filter(T(a_q), T(a_t), T(valid))
    ref = j_rot(J(a_q), J(a_t), J(valid))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# tests/test_pallas_kernels.py::TestHammingTop2's five cases
TOP2_CASES = {
    "aligned": (256, 512, 0, 0, 0),
    "ragged": (100, 300, 0, 0, 1),
    "masked_targets": (128, 256, 0, 200, 2),
    "masked_queries": (64, 128, 30, 0, 3),
    "single_tile": (32, 64, 0, 0, 4),
}


def top2_inputs(Q, Tn, q_invalid, t_invalid, seed):
    kq, kt = jax.random.split(jax.random.PRNGKey(seed))
    q = np.asarray(jax.random.randint(kq, (Q, 32), 0, 256, dtype=jnp.uint8))
    t = np.asarray(jax.random.randint(kt, (Tn, 32), 0, 256, dtype=jnp.uint8))
    return q, np.arange(Q) < Q - q_invalid, t, np.arange(Tn) < Tn - t_invalid


@pytest.mark.parametrize("case", list(TOP2_CASES))
def test_hamming_top2_plain_matches_reference_and_pallas(case):
    q, qv, t, tv = top2_inputs(*TOP2_CASES[case])
    ours = [a.numpy() for a in hk.hamming_top2(T(q), T(qv), T(t), T(tv))]  # CPU: plain
    ref = [np.asarray(a) for a in j_top2_ref(J(q), J(qv), J(t), J(tv))]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    # the Pallas kernel in interpret mode: equal on valid queries (its idx
    # for an invalid query is not defined)
    kern = [np.asarray(a) for a in pk.hamming_top2(q, jnp.asarray(qv), t, jnp.asarray(tv),
                                                   interpret=True)]
    for a, b in zip(ours, kern):
        np.testing.assert_array_equal(a[qv], b[qv])
    assert hk.launch_counts()["hamming_top2"] == 0  # plain calls are not launches


def test_hamming_top2_edge_cases():
    rng = np.random.default_rng(5)
    q, t = rand_desc(rng, 20), rand_desc(rng, 30)
    t[7] = t[3]  # a duplicated target: ties go to the lower index, second == best
    q[0] = t[3]
    tv = np.zeros(30, bool)
    tv[[3, 7, 12]] = True
    idx, best, second = hk.hamming_top2(T(q), T(np.ones(20, bool)), T(t), T(tv))
    assert (int(idx[0]), int(best[0]), int(second[0])) == (3, 0, 0)
    one = np.zeros(30, bool)
    one[12] = True  # a single valid target: second is BIG
    idx, best, second = hk.hamming_top2(T(q), T(np.ones(20, bool)), T(t), T(one))
    assert torch.all(idx == 12) and torch.all(second == hk.BIG)
    idx, best, second = hk.hamming_top2(T(q), T(np.zeros(20, bool)), T(t), T(one))
    assert torch.all(idx == 0) and torch.all(best == hk.BIG)
    with pytest.raises(TypeError):
        hk.hamming_top2(T(q).int(), T(np.ones(20, bool)), T(t), T(one))


def assert_same_matches(ours, ref):
    idx, best, ok = (a.numpy() for a in ours)
    r_idx, r_best, r_ok = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(idx[ok], r_idx[ok])
    np.testing.assert_array_equal(best[ok], r_best[ok])
    return ok


def feature_pair(seed, n=256, n_bits=6):
    """Two synthetic feature sets: frame 2 holds frame 1's features, moved
    by a few pixels, rotated by ~20 degrees and with a few bits flipped,
    shuffled, plus distractors; some slots invalid."""
    rng = np.random.default_rng(seed)
    xy1 = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    d1 = rand_desc(rng, n)
    perm = rng.permutation(n)
    xy2 = (xy1[perm] + rng.normal(0, 3, (n, 2))).astype(np.float32)
    d2 = perturb(rng, d1[perm], n_bits)
    d2[: n // 8] = rand_desc(rng, n // 8)  # distractors
    d2[n // 8: n // 4] = d2[n // 4: 3 * n // 8]  # duplicated descriptors: equal distances
    a1 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    a2 = (a1[perm] + np.deg2rad(20) + rng.normal(0, 0.05, n)).astype(np.float32)
    o1, o2 = rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 4, n).astype(np.int32)
    v1, v2 = rng.random(n) < 0.9, rng.random(n) < 0.9
    return (xy1, d1, v1, a1, o1), (xy2, d2, v2, a2, o2)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_brute_matches_jax(seed):
    (_, d1, v1, a1, _), (_, d2, v2, a2, _) = feature_pair(seed)
    for kw in (dict(check_rotation=False), dict(check_rotation=True),
               dict(th_dist=256, nn_ratio=1.0, check_rotation=False)):
        ours = tm.match_brute(T(d1), T(v1), T(d2), T(v2), q_angle=T(a1), t_angle=T(a2), **kw)
        ref = j_brute(J(d1), J(v1), J(d2), J(v2), q_angle=J(a1), t_angle=J(a2), **kw)
        ok = assert_same_matches(ours, ref)
        assert ok.sum() > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_window_searches_match_jax(seed):
    (xy1, d1, v1, a1, o1), (xy2, d2, v2, a2, o2) = feature_pair(seed)
    args = [T(a) for a in (xy1, d1, v1, a1, o1, xy2, d2, v2, a2, o2)]
    ok = assert_same_matches(
        tm.search_for_initialization(*args),
        j_init(*[J(a) for a in (xy1, d1, v1, a1, o1, xy2, d2, v2, a2, o2)]))
    assert ok.sum() > 100
    rng = np.random.default_rng(seed + 10)
    radius = rng.uniform(4, 20, len(xy1)).astype(np.float32)
    omin = np.zeros(len(xy1), np.int32)
    omax = rng.integers(1, 4, len(xy1)).astype(np.int32)
    ours = tm.match_in_window(T(xy1), T(d1), T(v1), T(xy2), T(d2), T(v2), T(radius),
                              t_octave=T(o2), octave_min=T(omin), octave_max=T(omax))
    ref = j_window(J(xy1), J(d1), J(v1), J(xy2), J(d2), J(v2), J(radius), t_octave=J(o2),
                   octave_min=J(omin), octave_max=J(omax))
    assert assert_same_matches(ours, ref).sum() > 50
    ours = tm.match_in_window(T(xy1), T(d1), T(v1), T(xy2), T(d2), T(v2), 10.0)
    ref = j_window(J(xy1), J(d1), J(v1), J(xy2), J(d2), J(v2), 10.0)
    assert_same_matches(ours, ref)


def test_triangulation_search_and_epipolar_match_jax():
    (xy1, d1, v1, a1, _), (xy2, d2, v2, a2, _) = feature_pair(3)
    rng = np.random.default_rng(3)
    F = rng.normal(size=(3, 3)).astype(np.float32) * np.float32(1e-3)
    np.testing.assert_allclose(
        tm.epipolar_line_dist2(T(F), T(xy1), T(xy2)).numpy(),
        np.asarray(jm.epipolar_line_dist2(jnp.asarray(F), jnp.asarray(xy1), jnp.asarray(xy2))),
        rtol=1e-5, atol=1e-3)
    s1 = rng.choice([1.0, 1.44, 2.0736], len(xy1)).astype(np.float32)
    s2 = rng.choice([1.0, 1.44, 2.0736], len(xy2)).astype(np.float32) * np.float32(1e5)
    ours = tm.search_for_triangulation(T(d1), T(v1), T(xy1), T(a1), T(s1), T(d2), T(v2),
                                       T(xy2), T(a2), T(s2), T(F))
    ref = j_tri(*[J(a) for a in (d1, v1, xy1, a1, s1, d2, v2, xy2, a2, s2, F)])
    assert assert_same_matches(ours, ref).sum() > 20


def test_unique_target_and_predict_octave_match_jax():
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 20, 200)
    dist = rng.integers(0, 5, 200).astype(np.int32)
    ok = rng.random(200) < 0.7
    d = rng.uniform(0.1, 20, 500).astype(np.float32)
    md = rng.uniform(1, 30, 500).astype(np.float32)
    unique, octave = jax.jit(lambda *a: (jm._unique_target(*a[:3], 20), jm.predict_octave(*a[3:])))(
        J(idx), J(dist), J(ok), J(d), J(md))
    np.testing.assert_array_equal(tm._unique_target(T(idx), T(dist), T(ok), 20).numpy(),
                                  np.asarray(unique))
    np.testing.assert_array_equal(tm.predict_octave(T(d), T(md)).numpy(), np.asarray(octave))
