"""The port's loop closer against the JAX package's on the drifted
out-and-back map of tests/test_loop_closing.py (``build_drifted_map``: 11
keyframes, the return leg drifted by up to 0.35 m), converted with
``convert.map_state_fields``; both finders get the same vocabulary (trained
by JAX with PRNGKey(0), converted).

RANSAC: the JAX finder splits PRNGKey(1234) once per candidate and draws
with ``jax.random.categorical``; the port's finder gets a ``sample``
callable that makes the same draws.  Tolerances: outcomes, counts, masks,
links and loop edges equal; Sim3s, poses and landmark positions within 1e-4
(float32, sums in another order); the pose-graph cost within 1e-4 relative;
the GBA that follows the closure within the bounds of __graft_entry__.py:
144-148 (cost within 5% + 1e-3, camera centres within 5 mm).  Ties: the
essential graph's covisibility edges are picked from integer weights built
to tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.models import keyframe_db as jkdb
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.ops import bow as jbow
from ccm_slam_tpu.runtime import loop_closing as jlc
from ccm_slam_tpu.runtime.tracking import apply_ba_result as j_apply
from ccm_slam_tpu.runtime.tracking import build_ba_problem as j_build
from ccm_slam_tpu.solvers import ba as jba
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.config import CameraConfig
from ccm_slam_tpu_torch.models import keyframe_db as kdb
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.runtime import loop_closing as lc
from ccm_slam_tpu_torch.runtime.tracking import apply_ba_result, build_ba_problem
from ccm_slam_tpu_torch.solvers import ba
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_loop_closing import N_WORDS, build_drifted_map

QUERY = 10


class JaxDraws:
    """The JAX finder's RANSAC draws: PRNGKey(1234 + map_id), split once per
    candidate, ``jax.random.categorical`` over log(match mask)."""

    def __init__(self, map_id=0):
        self.rng = jax.random.PRNGKey(1234 + map_id)
        self.keys = []

    def __call__(self, okm):
        self.rng, key = jax.random.split(self.rng)
        self.keys.append(key)
        logits = jnp.log(jnp.asarray(okm.cpu().numpy()).astype(jnp.float32) + 1e-12)
        return torch.as_tensor(np.asarray(jax.random.categorical(key, logits, shape=(300, 3))))


@pytest.fixture(scope="module")
def run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # batched 3x3 products: per-op overhead dominates on the CPU
    jm, jcfg, jcam, wdesc, xs_true, drift = build_drifted_map()
    vocab = jbow.train_vocabulary(jax.random.PRNGKey(0), wdesc, jnp.ones(wdesc.shape[0], bool),
                                  n_words=N_WORDS, iters=6)
    jf = jlc.LoopFinder(cfg=jcfg, cam=jcam, vocab=vocab, db=jkdb.empty_db(16, N_WORDS), map_id=0)
    cfg = convert.system_config_from(jcfg)
    cam = Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")
    m = convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")
    tf = lc.LoopFinder(cfg=cfg, cam=cam, vocab=convert.vocabulary_from_numpy(
        convert.vocabulary_fields(vocab), "cpu"), db=kdb.empty_db(16, N_WORDS, "cpu"), map_id=0)
    for k in range(QUERY):
        jf.insert_keyframe(jm, k)
        tf.insert_keyframe(m, k)
    db_j, db_t = jf.db, tf.db
    jm2, jclosed = jf.try_close(jm, QUERY)
    draws = JaxDraws()
    m2, closed = tf.try_close(m, QUERY, sample=draws)
    yield dict(jm=jm, jcfg=jcfg, jcam=jcam, jf=jf, jm2=jm2, jclosed=jclosed, cfg=cfg, cam=cam,
               m=m, tf=tf, m2=m2, closed=closed, draws=draws, db_j=db_j, db_t=db_t,
               W_j=jms.covisibility_matrix(jm), W=ms.covisibility_matrix(m))
    torch.set_num_threads(n)


def close(ours, ref, atol=1e-4, name=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref), rtol=1e-4,
                               atol=atol, err_msg=name)


def test_try_close_outcome_matches_jax(run):
    assert run["closed"] and run["jclosed"]
    assert run["tf"].last_loop_kf_id == run["jf"].last_loop_kf_id == QUERY
    assert run["tf"].prev_groups == run["jf"].prev_groups == []
    assert run["tf"].stats["sim3_attempts"] == len(run["draws"].keys) == 1
    close(run["tf"].db.vectors, run["jf"].db.vectors, 1e-6)
    np.testing.assert_array_equal(run["tf"].db.valid.numpy(), np.asarray(run["jf"].db.valid))


def test_detect_matches_jax(run):
    """The candidates of the query (BoW floor, covisibility exclusion, group
    accumulation) on the databases as they stood before try_close."""
    jf = jlc.LoopFinder(cfg=run["jcfg"], cam=run["jcam"], vocab=run["jf"].vocab, db=run["db_j"])
    tf = lc.LoopFinder(cfg=run["cfg"], cam=run["cam"], vocab=run["tf"].vocab, db=run["db_t"])
    assert tf.detect(run["m"], QUERY, run["W"]) == jf.detect(run["jm"], QUERY, run["W_j"]) == [0]
    np.testing.assert_array_equal(run["W"].numpy(), np.asarray(run["W_j"]))


@pytest.fixture(scope="module")
def sim3_pair(run):
    key = run["draws"].keys[0]
    est_j = jlc.estimate_sim3(key, run["jm"], jnp.int32(QUERY), jnp.int32(0), run["jcam"],
                              run["jcfg"])
    draws = JaxDraws()
    est = lc.estimate_sim3(run["m"], QUERY, 0, run["cam"], run["cfg"], idx=draws)
    assert len(draws.keys) == 1 and bool(jnp.all(draws.keys[0] == key))
    return est, est_j


def test_estimate_sim3_matches_jax(sim3_pair):
    est, est_j = sim3_pair
    assert bool(est["success"]) and bool(est_j["success"])
    for name in ("n_matches", "n_inliers"):
        assert int(est[name]) == int(est_j[name]), name
    np.testing.assert_array_equal(est["matched_mp"].numpy(), np.asarray(est_j["matched_mp"]))
    for name in ("s", "R", "t"):
        close(getattr(est["S_qc"], name), getattr(est_j["S_qc"], name), name=name)


@pytest.fixture(scope="module")
def guided_pair(run, sim3_pair):
    est, est_j = sim3_pair
    gp_j = jlc.guided_projection_count(run["jm"], jnp.int32(QUERY), jnp.int32(0), est_j["S_qc"],
                                       run["jcam"], run["jcfg"], run["W_j"])
    gp = lc.guided_projection_count(run["m"], QUERY, 0, est["S_qc"], run["cam"], run["cfg"],
                                    run["W"])
    return gp, gp_j


def test_guided_projection_count_matches_jax(guided_pair):
    (n, mask, t_idx, okm), (n_j, mask_j, t_idx_j, okm_j) = guided_pair
    assert int(n) == int(n_j) >= 40
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(okm.numpy(), np.asarray(okm_j))
    np.testing.assert_array_equal(t_idx.numpy()[okm.numpy()], np.asarray(t_idx_j)[okm.numpy()])


@pytest.fixture(scope="module")
def corrected(run, sim3_pair, guided_pair):
    (est, est_j), (gp, gp_j) = sim3_pair, guided_pair
    out_j = jlc.correct_loop(run["jm"], jnp.int32(QUERY), jnp.int32(0), est_j["S_qc"],
                             run["jcam"], run["jcfg"], loop_mask=gp_j[1], gp_t_idx=gp_j[2],
                             gp_okm=gp_j[3])
    out = lc.correct_loop(run["m"], QUERY, 0, est["S_qc"], run["cam"], run["cfg"],
                          loop_mask=gp[1], gp_t_idx=gp[2], gp_okm=gp[3])
    return out, out_j


def test_correct_loop_matches_jax(run, corrected):
    (m2, cost, info), (jm2, cost_j, info_j) = corrected
    a, b = convert.map_state_to_numpy(m2), convert.map_state_fields(jm2)
    for name in ("R_cw", "t_cw"):
        close(torch.as_tensor(a["kfs"][name]), b["kfs"][name], name=name)
    for name in ("pose_version", "loop_edges", "mp_idx"):  # mp_idx: the fused associations
        np.testing.assert_array_equal(a["kfs"][name], np.asarray(b["kfs"][name]), err_msg=name)
    for name in ("bad", "obs_kf", "obs_n", "pos_version"):
        np.testing.assert_array_equal(a["mps"][name], np.asarray(b["mps"][name]), err_msg=name)
    ok = a["mps"]["valid"] & ~a["mps"]["bad"]
    close(torch.as_tensor(a["mps"]["pos"][ok]), np.asarray(b["mps"]["pos"])[ok], name="pos")
    assert abs(float(cost) - float(cost_j)) <= 1e-4 * abs(float(cost_j))
    for key in info:
        assert int(info[key]) == int(info_j[key]), key
    assert QUERY in a["kfs"]["loop_edges"][0] and 0 in a["kfs"]["loop_edges"][QUERY]
    # the same map as the whole try_close produced
    assert torch.equal(m2.kfs.mp_idx, run["m2"].kfs.mp_idx)
    close(m2.kfs.t_cw, run["m2"].kfs.t_cw.numpy(), 1e-6)


def test_essential_graph_covis_edges_ties_match_jax_top_k():
    """The edge pick of correct_loop on integer weights built to tie, among
    the strong pairs and the weight-0 padding: JAX's lax.top_k order."""
    rng = np.random.default_rng(8)
    K = 16
    W = rng.choice([0, 50, 100, 100, 120, 120], (K, K)).astype(np.int32)
    W = W + W.T
    alive = rng.random(K) > 0.2
    for E_cov in (K * 4, 12):
        i, j, valid, n = lc.covis_edges(torch.as_tensor(W), torch.as_tensor(alive), 200, E_cov)
        strong = jnp.triu((jnp.asarray(W) >= 200) & jnp.asarray(alive)[:, None]
                          & jnp.asarray(alive)[None, :], 1)
        topw, topi = jax.lax.top_k(jnp.where(strong, jnp.asarray(W), 0).reshape(-1), E_cov)
        np.testing.assert_array_equal(i.numpy(), np.asarray(topi // K))
        np.testing.assert_array_equal(j.numpy(), np.asarray(topi % K))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(topw > 0))
        assert int(n) == int(jnp.sum(strong)) > 12


def test_gba_after_closure_matches_jax(run):
    """The GBA the reference runs after the essential graph (two-keyframe
    gauge), on both packages' corrected maps."""
    jm2, m2 = run["jm2"], run["m2"]
    fixed = np.arange(16) < 2
    jp = j_build(jm2, run["jcam"], fixed_mask=jnp.asarray(fixed))
    R_j, t_j, X_j, cost_j, _ = jba.ba_solve(jp, iters=20)
    prob = build_ba_problem(m2, run["cam"], fixed_mask=torch.as_tensor(fixed))
    R, t, X, cost, _ = ba.ba_solve(prob, iters=20)
    assert abs(float(cost) - float(cost_j)) <= 0.05 * float(cost_j) + 1e-3
    alive = (m2.kfs.valid & ~m2.kfs.bad).numpy()
    ctr = -np.einsum("kji,kj->ki", R.numpy(), t.numpy())
    ctr_j = -np.einsum("kji,kj->ki", np.asarray(R_j), np.asarray(t_j))
    assert np.linalg.norm(ctr - ctr_j, axis=-1)[alive].max() < 5e-3
    # the end-of-loop drift (0.35 m) is gone, as the reference's own test asks
    moved = apply_ba_result(m2, R, t, X, torch.as_tensor(~fixed) & m2.kfs.valid)
    jmoved = j_apply(jm2, R_j, t_j, X_j, jnp.asarray(~fixed) & jm2.kfs.valid)
    x_after = moved.kfs.center().numpy()[QUERY, 0]
    assert abs(x_after) < 0.1 and abs(float(jmoved.kfs.center()[QUERY, 0])) < 0.1
