"""The port's BoW vocabulary, keyframe database and the loop closer's map
helpers (covisibility neighbors, spanning tree, loop edges, redundancy
culling, landmark replacement) against the JAX package's, on seeded numpy
inputs handed to both packages.

Randomness: the vocabulary's initial centroids are the JAX draw
(``jax.random.choice`` as ``train_vocabulary`` makes it), given to the port
as ``perm``.  Tolerances: words, counts, masks, indices and links equal; BoW
vectors, scores and idf within 1e-6 (float32 sums in another order);
redundancy ratios equal.  Ties: integer covisibility weights are built to
tie, and the port must pick JAX's lower index (``top_k_stable``,
first-index ``argmax``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import tiny_test_config as j_tiny
from ccm_slam_tpu.models import keyframe_db as jkdb
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.ops import bow as jbow
from ccm_slam_tpu.runtime import mapping as jmap
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.config import tiny_test_config
from ccm_slam_tpu_torch.models import keyframe_db as kdb
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.ops import bow
from ccm_slam_tpu_torch.runtime import mapping


def t(x):
    return torch.as_tensor(np.array(x))


def jax_map(fields):
    return jms.MapState(
        kfs=jms.KeyFrameStore(**{k: jnp.asarray(v) for k, v in fields["kfs"].items()}),
        mps=jms.MapPointStore(**{k: jnp.asarray(v) for k, v in fields["mps"].items()}),
        next_kf=jnp.int32(fields["next_kf"]), next_mp=jnp.int32(fields["next_mp"]),
        insert_counter=jnp.int32(fields["insert_counter"]))


def assert_maps_equal(ours, ref):
    a, b = convert.map_state_to_numpy(ours), convert.map_state_fields(ref)
    for sec in ("kfs", "mps"):
        for name, x in a[sec].items():
            y = np.asarray(b[sec][name])
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)


def descriptors(seed, N, n_centres=24, flips=20):
    """N descriptors around ``n_centres`` centres (``flips`` random bit flips
    each), a tenth invalid."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 256, (n_centres, 32), dtype=np.uint8)
    d = centres[rng.integers(0, n_centres, N)].copy()
    for _ in range(flips):
        d[np.arange(N), rng.integers(0, 32, N)] ^= (1 << rng.integers(0, 8, N)).astype(np.uint8)
    return d, rng.random(N) > 0.1


@pytest.mark.parametrize("N,n_words", [(600, 64), (40, 64)])
def test_train_vocabulary_matches_jax(N, n_words):
    descs, valid = descriptors(0, N)
    key = jax.random.PRNGKey(0)
    jv = jnp.asarray(valid)
    perm = jax.random.choice(key, N, shape=(n_words,), replace=N < n_words,
                             p=jv.astype(jnp.float32) / jnp.clip(jnp.sum(jv), 1))
    ref = jbow.train_vocabulary(key, jnp.asarray(descs), jv, n_words=n_words, iters=4)
    ours = bow.train_vocabulary(t(descs), t(valid), n_words=n_words, iters=4, perm=t(perm))
    np.testing.assert_array_equal(ours.words.numpy(), np.asarray(ref.words))
    np.testing.assert_allclose(ours.idf.numpy(), np.asarray(ref.idf), rtol=1e-6, atol=1e-6)


def test_train_vocabulary_draws_from_its_generator():
    descs, valid = descriptors(1, 300)
    a, b = (bow.train_vocabulary(t(descs), t(valid), n_words=32, iters=2,
                                 generator=torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a.words, b.words) and torch.equal(a.idf, b.idf)
    assert int((a.idf > 0).sum()) > 16


@pytest.fixture(scope="module")
def vocab_pair():
    descs, valid = descriptors(2, 500)
    ref = jbow.train_vocabulary(jax.random.PRNGKey(0), jnp.asarray(descs), jnp.asarray(valid),
                                n_words=48, iters=3)
    return ref, convert.vocabulary_from_numpy(convert.vocabulary_fields(ref), "cpu")


def test_transform_and_scores_match_jax(vocab_pair, tmp_path):
    ref, ours = vocab_pair
    descs, valid = descriptors(3, 3 * 96)
    descs, valid = descs.reshape(3, 96, 32), valid.reshape(3, 96)
    vj, wj = jbow.transform_batch(ref, jnp.asarray(descs), jnp.asarray(valid))
    v, w = bow.transform_batch(ours, t(descs), t(valid))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)
    v0, w0 = bow.transform(ours, t(descs[0]), t(valid[0]))
    assert torch.equal(v0, v[0]) and torch.equal(w0, w[0])
    db_valid = np.array([True, False, True])
    sj = jbow.score_against_database(vj[0], vj, jnp.asarray(db_valid))
    s = bow.score_against_database(v[0], v, t(db_valid))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)
    assert float(s[1]) == -1.0 and abs(float(s[0]) - 1.0) < 1e-6
    bow.save_vocabulary(str(tmp_path / "v.npz"), ours)
    back = bow.load_vocabulary(str(tmp_path / "v.npz"), "cpu")
    assert torch.equal(back.words, ours.words) and torch.equal(back.idf, ours.idf)


def db_inputs(seed=4, K=16, W=32):
    """A database with valid rows of two maps and a covisibility matrix whose
    integer weights tie (values from a small set)."""
    rng = np.random.default_rng(seed)
    vecs = rng.random((K, W)).astype(np.float32)
    vecs /= vecs.sum(1, keepdims=True)
    vecs[5] = vecs[9]  # equal vectors: equal scores
    valid = rng.random(K) > 0.15
    map_id = np.where(np.arange(K) < 13, 0, 1).astype(np.int32)
    Wc = rng.choice([0, 0, 0, 3, 3, 15, 15, 20], (K, K)).astype(np.int32)
    Wc = np.triu(Wc, 1)
    Wc = Wc + Wc.T
    return vecs, valid, map_id, Wc


def test_keyframe_db_add_remap_erase_match_jax():
    vecs, valid, map_id, _ = db_inputs()
    K, W = vecs.shape
    jd, td = jkdb.empty_db(K, W), kdb.empty_db(K, W, "cpu")
    for k in np.where(valid)[0]:
        jd = jkdb.add(jd, int(k), jnp.asarray(vecs[k]), int(map_id[k]))
        td = kdb.add(td, int(k), t(vecs[k]), int(map_id[k]))
    remap = np.where(np.arange(K) % 3 == 0, -1, np.cumsum(np.arange(K) % 3 != 0) - 1)
    jd, td = jkdb.remap(jd, remap), kdb.remap(td, remap)
    erase = np.arange(K) == 2
    jd, td = jkdb.erase(jd, jnp.asarray(erase)), kdb.erase(td, t(erase))
    for name in ("vectors", "valid", "map_id"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))


@pytest.mark.parametrize("query", [0, 5, 9])
def test_detect_loop_candidates_ties_match_jax(query):
    vecs, valid, map_id, Wc = db_inputs()
    K, W = vecs.shape
    jd = jkdb.KeyFrameDB(vectors=jnp.asarray(vecs), valid=jnp.asarray(valid),
                         map_id=jnp.asarray(map_id))
    td = convert.keyframe_db_from_numpy(convert.keyframe_db_fields(jd), "cpu")
    qv = vecs[query]
    ms_j, nb_j = jkdb.min_covisible_score(jd, jnp.asarray(qv), query, jnp.asarray(Wc))
    ms_t, nb_t = kdb.min_covisible_score(td, t(qv), query, t(Wc))
    assert bool(nb_t) == bool(nb_j)
    np.testing.assert_allclose(float(ms_t), float(ms_j), rtol=1e-6)
    floor = 0.0  # a floor of 0 keeps every eligible keyframe: group ties decide
    cand_j, s_j = jkdb.detect_loop_candidates(jd, jnp.asarray(qv), jnp.int32(query), jnp.int32(0),
                                              jnp.asarray(Wc), jnp.float32(floor))
    cand_t, s_t = kdb.detect_loop_candidates(td, t(qv), query, 0, t(Wc), torch.tensor(floor))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    acc_j, best_j = jkdb._accumulate_covis_groups(s_j, jnp.asarray(valid), jnp.asarray(Wc))
    acc_t, best_t = kdb._accumulate_covis_groups(s_t, t(valid), t(Wc))
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def client_map():
    fields, _, _ = problems.client_map_arrays(n_kf=12, kf_cap=16, n_points=400, seed=5)
    return fields


def test_covis_neighbors_and_spanning_tree_ties_match_jax(client_map):
    m = convert.map_state_from_numpy(client_map, "cpu")
    jm = jax_map(client_map)
    rng = np.random.default_rng(6)
    K = m.kfs.capacity
    Wc = rng.choice([0, 1, 4, 4, 9, 9], (K, K)).astype(np.int32)
    Wc = np.triu(Wc, 1)
    Wc = Wc + Wc.T
    for k in (0, 3, 11):
        ours = ms.covis_neighbors(t(Wc), k, 10, min_weight=4)
        ref = jms.covis_neighbors(jnp.asarray(Wc), k, 10, min_weight=4)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ms.spanning_tree(m, t(Wc)).numpy(),
                                  np.asarray(jms.spanning_tree(jm, jnp.asarray(Wc))))
    W = ms.covisibility_matrix(m)
    np.testing.assert_array_equal(ms.spanning_tree(m, W).numpy(),
                                  np.asarray(jms.spanning_tree(jm, jms.covisibility_matrix(jm))))


def test_add_loop_edge_matches_jax(client_map):
    kfs = convert.map_state_from_numpy(client_map, "cpu").kfs
    jkfs = jax_map(client_map).kfs
    # duplicates are no-ops; the fifth partner of keyframe 0 overflows its table
    for a, b in ((0, 5), (5, 0), (0, 6), (0, 7), (0, 8), (0, 9), (1, 2)):
        kfs, n = ms.add_loop_edge(kfs, a, b)
        jkfs, nj = jms.add_loop_edge(jkfs, a, b)
        assert int(n) == int(nj)
        np.testing.assert_array_equal(kfs.loop_edges.numpy(), np.asarray(jkfs.loop_edges))
    assert int(n) == 0 and (kfs.loop_edges[0] >= 0).all()


@pytest.mark.parametrize("red_thres", [0.5, 0.9])
def test_keyframe_redundancy_and_culling_match_jax(client_map, red_thres):
    m = convert.map_state_from_numpy(client_map, "cpu")
    jm = jax_map(client_map)
    cfg = dataclasses.replace(tiny_test_config(), mapping=dataclasses.replace(
        tiny_test_config().mapping, red_thres=red_thres))
    jcfg = dataclasses.replace(j_tiny(), mapping=dataclasses.replace(j_tiny().mapping,
                                                                     red_thres=red_thres))
    np.testing.assert_array_equal(mapping.keyframe_redundancy(m, cfg).numpy(),
                                  np.asarray(jmap.keyframe_redundancy(jm, jcfg)))
    ours, n = mapping.cull_redundant_keyframes(m, cfg, protect_recent=4)
    ref, nj = jmap.cull_redundant_keyframes(jm, jcfg, protect_recent=4)
    assert int(n) == int(nj)
    assert_maps_equal(ours, ref)
    if red_thres == 0.5:
        assert int(n) > 0


def test_replace_mappoints_follows_chains_where_jax_leaves_dead_links(client_map):
    """A batch x -> y, y -> z: the port moves x's links to z (the chain's
    end); the reference moves them one hop, to y, which it marks bad.
    Without a chain both agree."""
    m = convert.map_state_from_numpy(client_map, "cpu")
    jm = jax_map(client_map)
    linked = np.asarray(client_map["kfs"]["mp_idx"])
    ids, counts = np.unique(linked[linked >= 0], return_counts=True)
    x = int(ids[np.argmin(counts)])  # the least observed landmark
    rows_x = (linked == x).any(1)
    z = int(next(i for i in ids if not (linked[rows_x] == i).any()))  # never beside x
    y = int(next(i for i in ids if i not in (x, z)))
    u, v = int(ids[-1]), int(ids[-2])
    for loser, winner in (([u], [v]), ([x, y], [y, z])):
        ours = ms.replace_mappoints(m, torch.tensor(loser, dtype=torch.int32),
                                    torch.tensor(winner, dtype=torch.int32))
        ref = jms.replace_mappoints(jm, jnp.asarray(loser, jnp.int32),
                                    jnp.asarray(winner, jnp.int32))
        if len(loser) == 1:
            assert_maps_equal(ours, ref)
            continue
        had_x = linked == x
        assert had_x.any()
        assert (ours.kfs.mp_idx.numpy()[had_x] == z).all()
        assert (np.asarray(ref.kfs.mp_idx)[had_x] == y).all()  # links to a dead landmark
        assert ms.check_structure(ours) == []
        assert jms.check_structure(ref) != []


def test_culling_keeps_loop_edge_keyframes_where_jax_culls_them(client_map):
    """A redundant keyframe with a loop edge survives in the port (the
    reference's mbNotErase); the JAX package culls it.  With the loop edges
    hidden from it, the port culls exactly JAX's keyframes."""
    cfg = dataclasses.replace(tiny_test_config(), mapping=dataclasses.replace(
        tiny_test_config().mapping, red_thres=0.5))
    jcfg = dataclasses.replace(j_tiny(), mapping=dataclasses.replace(j_tiny().mapping,
                                                                     red_thres=0.5))
    m = convert.map_state_from_numpy(client_map, "cpu")
    culled, _ = mapping.cull_redundant_keyframes(m, cfg, protect_recent=4)
    k = int(torch.nonzero(culled.kfs.bad)[0])
    kfs, _ = ms.add_loop_edge(m.kfs, k, 11)
    fields = convert.map_state_to_numpy(m.replace(kfs=kfs))
    ours, n = mapping.cull_redundant_keyframes(m.replace(kfs=kfs), cfg, protect_recent=4)
    ref, nj = jmap.cull_redundant_keyframes(jax_map(fields), jcfg, protect_recent=4)
    assert not bool(ours.kfs.bad[k]) and bool(ref.kfs.bad[k])
    assert int(n) == int(nj) - 1
    hidden = kfs.replace(loop_edges=torch.full_like(kfs.loop_edges, ms.NO_KF))
    as_jax, n_as_jax = mapping.cull_redundant_keyframes(m.replace(kfs=hidden), cfg,
                                                        protect_recent=4)
    np.testing.assert_array_equal(as_jax.kfs.bad.numpy(), np.asarray(ref.kfs.bad))
    assert int(n_as_jax) == int(nj)
