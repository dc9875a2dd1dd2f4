"""The port's map store against the JAX package's, function by function, on a
small client map (``problems.client_map_arrays``) handed to both packages as
the same arrays.  Integer and bool fields must be equal; float fields agree
to 1e-5 (relative) + 1e-5 (absolute).  ``check_structure`` runs after every
mutation and must report exactly what the JAX package's reports."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.models import map_store as ms

RTOL = ATOL = 1e-5


def jax_map(fields):
    return jms.MapState(
        kfs=jms.KeyFrameStore(**{k: jnp.asarray(v) for k, v in fields["kfs"].items()}),
        mps=jms.MapPointStore(**{k: jnp.asarray(v) for k, v in fields["mps"].items()}),
        next_kf=jnp.int32(fields["next_kf"]), next_mp=jnp.int32(fields["next_mp"]),
        insert_counter=jnp.int32(fields["insert_counter"]))


def assert_same_map(ours, ref):
    a, b = convert.map_state_to_numpy(ours), convert.map_state_fields(ref)
    for part in ("kfs", "mps"):
        for name, x in a[part].items():
            y = b[part][name]
            assert x.dtype == y.dtype, (part, name, x.dtype, y.dtype)
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=f"{part}.{name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{part}.{name}")
    for name in ("next_kf", "next_mp", "insert_counter"):
        assert int(a[name]) == int(b[name]), name
    assert ms.check_structure(ours) == jms.check_structure(ref)


@pytest.fixture(scope="module")
def base():
    fields, _, _ = problems.client_map_arrays(seed=3)
    return fields


def both(fields):
    return convert.map_state_from_numpy(fields, "cpu"), jax_map(fields)


def test_conversion_round_trip(base):
    m, j = both(base)
    assert_same_map(m, j)
    assert ms.check_structure(m) == []
    empty = ms.empty_map(8, 64, 16, 4, "cpu")
    assert_same_map(empty, jms.empty_map(8, 64, 16, 4))


def test_add_mappoints_and_keyframe(base):
    m, j = both(base)
    rng = np.random.RandomState(0)
    B = 40
    new_valid = rng.rand(B) < 0.7
    args = dict(pos=rng.randn(B, 3).astype(np.float32), desc=rng.randint(0, 256, (B, 32)).astype(
        np.uint8), normal=rng.randn(B, 3).astype(np.float32),
        min_dist=rng.rand(B).astype(np.float32), max_dist=rng.rand(B).astype(np.float32) + 2,
        ref_kf=np.full(B, 5, np.int32), mp_ids=np.arange(B, dtype=np.int32) + 900,
        client_id=np.zeros(B, np.int32), new_valid=new_valid)
    n_new = int(new_valid.sum())
    m, idx = ms.add_mappoints(m, torch.tensor(n_new), **{k: torch.as_tensor(v)
                                                        for k, v in args.items()})
    j, jidx = jms.add_mappoints(j, jnp.int32(n_new), **{k: jnp.asarray(v)
                                                       for k, v in args.items()})
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_same_map(m, j)

    # a keyframe observing some of the new landmarks (and a repeated one)
    N = base["kfs"]["xy"].shape[1]
    assoc = np.full(N, -1, np.int32)
    got = np.asarray(jidx)[new_valid]
    assoc[: len(got)] = got
    kf = dict(xy=rng.rand(N, 2).astype(np.float32) * 500,
              desc=rng.randint(0, 256, (N, 32)).astype(np.uint8),
              octave=rng.randint(0, 3, N).astype(np.int32), angle=np.zeros(N, np.float32),
              feat_valid=np.ones(N, bool), mp_assoc=assoc)
    R, t = np.eye(3, dtype=np.float32), np.array([0.5, 0, 0], np.float32)
    m, k = ms.add_keyframe(m, 6, 0, 1.5, torch.as_tensor(R), torch.as_tensor(t),
                           **{n: torch.as_tensor(v) for n, v in kf.items()})
    j, jk = jms.add_keyframe(j, jnp.int32(6), jnp.int32(0), jnp.float32(1.5), jnp.asarray(R),
                             jnp.asarray(t), **{n: jnp.asarray(v) for n, v in kf.items()})
    assert int(k) == int(jk) == 6
    assert_same_map(m, j)


def test_covisibility_and_rows(base):
    m, j = both(base)
    W = ms.covisibility_matrix(m)
    np.testing.assert_array_equal(W.numpy(), np.asarray(jms.covisibility_matrix(j)))
    for k in range(6):
        np.testing.assert_array_equal(ms.covis_row(m, k).numpy(),
                                      np.asarray(jms.covis_row(j, jnp.int32(k))))
    assert int(W.sum()) > 0


def test_normals_depth_and_descriptors(base):
    m, j = both(base)
    m = ms.update_normal_and_depth(m, 1.2, 8)
    j = jms.update_normal_and_depth(j, 1.2, 8)
    assert_same_map(m, j)
    m = ms.compute_distinctive_descriptors(m, chunk=100)
    j = jms.compute_distinctive_descriptors(j)
    assert_same_map(m, j)


def test_median_even_count_averages_like_jax():
    """jnp.median / jnp.nanmedian average the two middle values;
    torch.median / torch.nanmedian return the lower one."""
    x = np.array([[3.0, 1.0, 4.0, 10.0], [7.0, 7.0, 1.0, 2.0]], np.float32)
    np.testing.assert_array_equal(ms.median_last(torch.as_tensor(x)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), axis=-1)))
    assert float(torch.median(torch.as_tensor(x[0]))) != float(jnp.median(x[0]))
    for v in ([np.nan, 2.0, 5.0, np.nan, 1.0, 8.0], [np.nan, np.nan], [0.5, np.nan, 3.0]):
        v = np.asarray(v, np.float32)
        ours, ref = float(ms.nanmedian(torch.as_tensor(v))), float(jnp.nanmedian(v))
        assert ours == ref or (np.isnan(ours) and np.isnan(ref)), (v, ours, ref)


def test_scatters_with_colliding_indices_match_jax():
    """Masked writes are adds on the live lanes (the masked ones write spare
    rows; the reference adds a delta of 0 there), and bool
    flags take monotone max/min scatters: with colliding indices both equal
    JAX's ``.at[].add`` / ``.at[].max`` / ``.at[].min`` (an ``index_put`` set
    would keep an arbitrary one of the colliding writes)."""
    idx = np.array([2, 2, 5, 2, 0, 5], np.int64)
    mask = np.array([True, False, True, False, True, True])
    x = np.arange(8, dtype=np.int32) * 10
    delta = np.where(mask, np.array([7, 99, 3, -99, 1, 4], np.int32), 0)
    np.testing.assert_array_equal(
        ms._add_at(torch.as_tensor(x), (torch.as_tensor(idx),), torch.as_tensor(delta),
                   torch.as_tensor(mask)).numpy(),
        np.asarray(jnp.asarray(x).at[idx].add(delta)))
    u8 = np.array([250, 3, 7, 0], np.uint8)
    d8 = np.array([10, 250, 1, 0], np.uint8)  # wraps, as the reference's uint8 add does
    i8 = np.array([0, 1, 0, 3], np.int64)
    np.testing.assert_array_equal(
        ms._add_at(torch.as_tensor(u8), (torch.as_tensor(i8),), torch.as_tensor(d8),
                   torch.ones(4, dtype=torch.bool)).numpy(),
        np.asarray(jnp.asarray(u8).at[i8].add(d8)))
    flags = np.array([False, True, False, True, False, True, False, False])
    src = np.array([True, False, False, False, False, True])
    for reduce, ref in (("amax", jnp.asarray(flags).at[idx].max(src)),
                        ("amin", jnp.asarray(flags).at[idx].min(src))):
        ours = ms._bool_at(torch.as_tensor(flags), torch.as_tensor(idx), torch.as_tensor(src),
                           reduce)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=reduce)


def test_erase_and_rebuild(base):
    m, j = both(base)
    rng = np.random.RandomState(1)
    M, K = base["mps"]["valid"].shape[0], base["kfs"]["valid"].shape[0]
    mp_mask = rng.rand(M) < 0.1
    m = ms.erase_mappoints(m, torch.as_tensor(mp_mask))
    j = jms.erase_mappoints(j, jnp.asarray(mp_mask))
    assert_same_map(m, j)
    kf_mask = np.zeros(K, bool)
    kf_mask[2] = True
    m = ms.erase_keyframes(m, torch.as_tensor(kf_mask))
    j = jms.erase_keyframes(j, jnp.asarray(kf_mask))
    assert_same_map(m, j)
    m = ms.compact_observations(m)
    j = jms.compact_observations(j)
    assert_same_map(m, j)
    m = ms.rebuild_observations(m)
    j = jms.rebuild_observations(j)
    assert_same_map(m, j)


def test_rebuild_drops_overflow_links_both_sides():
    fields, _, _ = problems.client_map_arrays(max_obs=2, seed=4)
    m, j = both(fields)
    m, j = ms.rebuild_observations(m), jms.rebuild_observations(j)
    assert_same_map(m, j)
    assert ms.check_structure(m) == []


def test_replace_mappoints(base):
    m, j = both(base)
    n = int(base["next_mp"])
    loser = np.array([3, 10, 11, -1, 20, 20], np.int32)
    winner = np.array([4, 12, 12, 5, 21, 22], np.int32)  # colliding losers: max wins
    assert n > 30
    m = ms.replace_mappoints(m, torch.as_tensor(loser), torch.as_tensor(winner))
    j = jms.replace_mappoints(j, jnp.asarray(loser), jnp.asarray(winner))
    assert_same_map(m, j)
    m2 = ms.replace_mappoints(m, torch.as_tensor(loser), torch.as_tensor(winner), rebuild=False)
    j2 = jms.replace_mappoints(j, jnp.asarray(loser), jnp.asarray(winner), rebuild=False)
    np.testing.assert_array_equal(m2.kfs.mp_idx.numpy(), np.asarray(j2.kfs.mp_idx))


def test_compaction(base):
    m, j = both(base)
    rng = np.random.RandomState(2)
    M, K = base["mps"]["valid"].shape[0], base["kfs"]["valid"].shape[0]
    kf_mask = np.zeros(K, bool)
    kf_mask[1] = True
    mp_mask = rng.rand(M) < 0.15
    m = ms.erase_keyframes(ms.erase_mappoints(m, torch.as_tensor(mp_mask)),
                           torch.as_tensor(kf_mask))
    j = jms.erase_keyframes(jms.erase_mappoints(j, jnp.asarray(mp_mask)), jnp.asarray(kf_mask))
    for a, b in zip(ms.compaction_remap(m), jms.compaction_remap(j)):
        np.testing.assert_array_equal(a, b)
    m, j = ms.compact_map(m), jms.compact_map(j)
    assert_same_map(m, j)
    assert ms.check_structure(m) == []


def test_check_structure_reports_faults(base):
    fields = {k: (dict(v) if isinstance(v, dict) else v) for k, v in base.items()}
    mp_idx = fields["kfs"]["mp_idx"].copy()
    f = int(np.where(mp_idx[0] >= 0)[0][0])
    mp_idx[0, f] = int(base["next_mp"]) + 5  # a forward link to a dead landmark
    fields["kfs"]["mp_idx"] = mp_idx
    m, j = both(fields)
    errs = ms.check_structure(m)
    assert errs and errs == jms.check_structure(j)
