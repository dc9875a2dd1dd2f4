"""The server's map and bank functions of the port against the JAX package's:
``map_store.grow_map``, ``add_keyframes``, ``vicinity_khop``,
``transform_map``, ``merge_maps`` (tests/test_merge.py's cases, and a merge
that runs past the arena's end), ``rebuild_observations`` on colliding and
overflowing observations (also against its previous colliding-scatter form),
``keyframe_db.batch_vectors``, ``register_vectors``, ``grow``, ``regrid``
and ``detect_map_match_candidates`` (group accumulation over neighbour
lists, ties built in), and ``bow.train_vocabulary_large`` with the port's
copy of the 32k vocabulary.  Integers exact; poses and positions rtol 1e-5
(atol 1e-5); BoW vectors and scores 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.io.synthetic import build_agent_map, make_world
from ccm_slam_tpu.models import keyframe_db as jkdb
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.ops import bow as jbow
from ccm_slam_tpu.utils.lie import Sim3 as JSim3
from ccm_slam_tpu.utils.lie import so3_exp
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.models import keyframe_db as kdb
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.ops import bow
from tests.test_map_store import N_FEAT, add_kf, add_mps, fresh
from tests.test_torch_bow_kfdb import descriptors
from tests.test_torch_communicator import assert_maps_close
from tools.time_rebuild_observations import rebuild_colliding


def port(jm):
    return convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")


def t(x):
    return torch.as_tensor(np.array(x))


def map_with(n_kf, n_mp, id_base=0):
    """tests/test_merge.py's small map: keyframe i sees landmarks i and i+1."""
    m = fresh()
    m, _ = add_mps(m, n_mp)
    for i in range(n_kf):
        assoc = jnp.full((N_FEAT,), jms.NO_MP).at[0].set(i % n_mp).at[1].set((i + 1) % n_mp)
        m, _ = add_kf(m, id_base + i, mp_assoc=assoc)
    return m


@pytest.fixture(scope="module")
def corridor():
    rng = np.random.RandomState(1)
    world, wdesc = make_world(rng, n=300)
    gauge = JSim3(s=jnp.float32(1.5), R=so3_exp(jnp.array([0.0, 0.0, 0.05])),
                  t=jnp.array([0.4, -0.2, 0.1]))
    m_b = build_agent_map(world, wdesc, [0.0, 1.0, 2.0], JSim3.identity(), client_id=1)
    m_a = build_agent_map(world, wdesc, [3.0, 2.0, 1.0], gauge, kf_id_base=50, client_id=0)
    return m_a, m_b, gauge


def test_transform_map_matches_jax():
    jm = map_with(3, 5)
    s, R, tr = 1.7, so3_exp(jnp.array([0.1, -0.3, 0.2])), jnp.array([1.0, 2.0, -0.5])
    ref = jms.transform_map(jm, jnp.float32(s), R, tr)
    ours = ms.transform_map(port(jm), torch.tensor(s), t(R), t(tr))
    assert_maps_close(ours, ref)


@pytest.mark.parametrize("case", ["counts_and_remap", "transform", "gauge_of_a_match",
                                  "runs_past_the_end"])
def test_merge_maps_matches_jax(case, corridor):
    """tests/test_merge.py's merges, the corridor maps of
    tests/test_map_matching.py under the inverse gauge, and a merge whose
    spliced arena runs past the target's last slot (clipped: the last slot
    keeps the target's row, as the reference's scatter leaves it)."""
    if case == "counts_and_remap":
        ma, mb, S = map_with(3, 4), map_with(2, 3, id_base=100), (1.0, jnp.eye(3), jnp.zeros(3))
    elif case == "transform":
        ma, mb, S = map_with(2, 3), map_with(2, 3, id_base=50), (2.0, jnp.eye(3),
                                                                 jnp.array([10.0, 0.0, 0.0]))
    elif case == "gauge_of_a_match":
        m_a, m_b, gauge = corridor
        inv = gauge.inverse()
        ma, mb, S = m_b, jms.erase_keyframes(m_a, jnp.arange(16) == 1), (inv.s, inv.R, inv.t)
    else:
        ma = map_with(6, 8)
        mb = map_with(5, 6, id_base=20)
        S = (1.3, so3_exp(jnp.array([0.0, 0.2, 0.0])), jnp.array([0.5, 0.0, 0.0]))
    ref = jms.merge_maps(ma, mb, jnp.float32(S[0]), jnp.asarray(S[1]), jnp.asarray(S[2]))
    ours = ms.merge_maps(port(ma), port(mb), torch.tensor(float(S[0])), t(S[1]), t(S[2]))
    assert_maps_close(ours, ref)
    if case == "runs_past_the_end":
        assert int(ours.next_kf) == 11 > ours.kfs.capacity
    np.testing.assert_array_equal(ms.covisibility_matrix(ours).numpy(),
                                  np.asarray(jms.covisibility_matrix(ref)))


def test_grow_and_add_keyframes_match_jax(corridor):
    """grow_map keeps content and indices; add_keyframes lands a batch with
    masked rows, repeated landmarks across rows (ranked observation slots)
    and an observation table that overflows."""
    m_a, _, _ = corridor
    ref = jms.grow_map(m_a, 32, 2048)
    ours = ms.grow_map(port(m_a), 32, 2048)
    assert_maps_close(ours, ref)
    rng = np.random.RandomState(0)
    B, N = 5, m_a.kfs.n_feat
    assoc = np.full((B, N), -1, np.int32)
    assoc[:, :3] = [[0, 1, 2]] * B          # every row observes landmarks 0-2
    assoc[:, 3:6] = rng.randint(3, 40, (B, 3))
    new_valid = np.array([True, False, True, True, True])
    args = dict(
        kf_ids=np.arange(70, 70 + B, dtype=np.int32), client_ids=np.full(B, 3, np.int32),
        timestamps=rng.rand(B).astype(np.float32),
        R_cw=np.asarray(so3_exp(jnp.asarray(rng.randn(B, 3) * 0.1, jnp.float32))),
        t_cw=rng.randn(B, 3).astype(np.float32), xy=rng.rand(B, N, 2).astype(np.float32),
        desc=rng.randint(0, 256, (B, N, 32)).astype(np.uint8),
        octave=rng.randint(0, 8, (B, N)).astype(np.int32),
        angle=rng.rand(B, N).astype(np.float32), feat_valid=rng.rand(B, N) < 0.8,
        mp_assoc=assoc, new_valid=new_valid)
    ref, ref_idx = jms.add_keyframes(ref, **{k: jnp.asarray(v) for k, v in args.items()})
    ours, idx = ms.add_keyframes(ours, **{k: t(v) for k, v in args.items()})
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert_maps_close(ours, ref)


@pytest.mark.parametrize("root,max_kfs,hops", [(0, 4, 4), (2, 16, 1), (1, 3, 2)])
def test_vicinity_khop_matches_jax(corridor, root, max_kfs, hops):
    m_a, m_b, gauge = corridor
    inv = gauge.inverse()
    jm = jms.merge_maps(m_b, m_a, inv.s, inv.R, inv.t)
    sel_j, ok_j = jms.vicinity_khop(jm, jnp.int32(root), max_kfs, hops)
    sel, ok = ms.vicinity_khop(port(jm), root, max_kfs, hops)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))


def test_rebuild_observations_without_colliding_writes_matches_jax():
    """Forward links with many keyframes on one landmark (beyond its 4
    observation slots: the overflow is dropped from both sides), a dead
    keyframe and invalid features: the spare-row form gives JAX's integers
    and its own previous form's."""
    m = fresh()
    m, _ = add_mps(m, 6)
    for i in range(7):
        assoc = np.full(N_FEAT, -1, np.int32)
        assoc[:4] = [0, 1, 2, 3]             # landmark 0-3 on every keyframe: overflow
        assoc[4 + i % 3] = 4 + i % 2
        m, _ = add_kf(m, i, mp_assoc=jnp.asarray(assoc))
    fv = np.asarray(m.kfs.feat_valid).copy()
    fv[2, 1] = False
    m = m.replace(kfs=m.kfs.replace(feat_valid=jnp.asarray(fv), bad=m.kfs.bad.at[4].set(True)))
    ref = jms.rebuild_observations(m)
    ours = ms.rebuild_observations(port(m))
    assert_maps_close(ours, ref, rtol=0, atol=0)
    old = rebuild_colliding(port(m))
    for name in ("obs_kf", "obs_feat", "obs_n"):
        assert torch.equal(getattr(ours.mps, name), getattr(old.mps, name)), name
    assert torch.equal(ours.kfs.mp_idx, old.kfs.mp_idx)
    assert int((np.asarray(ref.mps.obs_n) == 4).sum()) == 4  # four landmarks overflowed


def test_keyframe_db_server_functions_match_jax():
    descs, valid = descriptors(5, 600)
    vocab = jbow.train_vocabulary(jax.random.PRNGKey(0), jnp.asarray(descs), jnp.asarray(valid),
                                  n_words=32, iters=3)
    tv = convert.vocabulary_from_numpy(convert.vocabulary_fields(vocab), "cpu")
    kd, kv = descs[:16 * 30].reshape(16, 30, 32), valid[:16 * 30].reshape(16, 30)
    arenas = np.array([3, -1, 0, 15, 3], np.int32)
    vj = jkdb.batch_vectors(vocab, jnp.asarray(kd), jnp.asarray(kv), jnp.asarray(arenas))
    v = kdb.batch_vectors(tv, t(kd), t(kv), t(arenas))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-6)
    mask = arenas >= 0
    mask[4] = False  # a repeated row, masked
    dbj = jkdb.register_vectors(jkdb.empty_db(16, 32), jnp.asarray(arenas), vj,
                                jnp.asarray(mask), jnp.int32(2))
    db = kdb.register_vectors(kdb.empty_db(16, 32, "cpu"), t(arenas), v, t(mask), 2)
    for name in ("vectors", "valid", "map_id"):
        np.testing.assert_allclose(getattr(db, name).numpy(), np.asarray(getattr(dbj, name)),
                                   atol=1e-6, err_msg=name)
    gj, g = jkdb.grow(dbj, 24), kdb.grow(db, 24)
    rj, r = jkdb.regrid(gj, 8, 12, 3), kdb.regrid(g, 8, 12, 3)
    for name in ("vectors", "valid", "map_id"):
        np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(gj, name)),
                                   atol=1e-6)
        np.testing.assert_allclose(getattr(r, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=1e-6)

    # a shared bank of three maps, neighbour lists with ties and self rows
    n, W = 24, 32
    rng = np.random.RandomState(6)
    vecs = rng.rand(n, W).astype(np.float32)
    vecs /= vecs.sum(1, keepdims=True)
    bank = dict(vectors=vecs, valid=rng.rand(n) < 0.9, map_id=np.repeat([0, 1, 2], 8).astype(
        np.int32))
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 10))
    for r0 in range(n):
        lo = (r0 // 8) * 8
        k = rng.randint(0, 8)
        nbr[r0, :k] = lo + rng.randint(0, 8, k)
    q = vecs[5] * 0.5 + vecs[17] * 0.5
    for map_id in (0, 1):
        cj, sj = jkdb.detect_map_match_candidates(
            jkdb.KeyFrameDB(**{k: jnp.asarray(x) for k, x in bank.items()}), jnp.asarray(q),
            jnp.int32(map_id), jnp.asarray(nbr), min_score=0.015)
        c, s = kdb.detect_map_match_candidates(
            kdb.KeyFrameDB(**{k: t(x) for k, x in bank.items()}), t(q), map_id, t(nbr),
            min_score=0.015)
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-6)
        assert c.any()


def test_train_vocabulary_large_matches_jax_and_the_port_keeps_vocab32k():
    descs, _ = descriptors(7, 700)
    key = jax.random.PRNGKey(3)
    perm = jax.random.choice(key, 700, shape=(96,), replace=False)
    ref = jbow.train_vocabulary_large(key, jnp.asarray(descs), n_words=96, iters=3, block=256)
    ours = bow.train_vocabulary_large(t(descs), n_words=96, iters=3, block=256, perm=t(perm))
    np.testing.assert_array_equal(ours.words.numpy(), np.asarray(ref.words))
    np.testing.assert_allclose(ours.idf.numpy(), np.asarray(ref.idf), rtol=1e-6, atol=1e-6)
    a = bow.train_vocabulary_large(t(descs), n_words=64, iters=2,
                                   generator=torch.Generator().manual_seed(1))
    b = bow.train_vocabulary_large(t(descs), n_words=64, iters=2,
                                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.words, b.words)
    bits = torch.tensor([[1, 0, 1], [1, 1, 0], [0, 1, 1]], dtype=torch.float32)
    np.testing.assert_array_equal(
        bow._majority_centroid(bits, torch.tensor([1.0, 2.0, 0.5])).numpy(),
        np.asarray(jbow._majority_centroid(jnp.asarray(bits.numpy()),
                                           jnp.asarray([1.0, 2.0, 0.5]))))
    # the port's own copy of the 32k codebook, byte for byte, loaded by default
    from pathlib import Path
    ref_file = Path(jbow.__file__).resolve().parents[1] / "data" / "vocab32k.npz"
    assert Path(bow.VOCAB32K).read_bytes() == ref_file.read_bytes()
    assert "ccm_slam_tpu_torch" in bow.VOCAB32K
    v = bow.load_vocabulary(device="cpu")
    jv = jbow.load_vocabulary(str(ref_file))
    assert v.n_words == 32768 and torch.equal(v.words, t(jv.words))
