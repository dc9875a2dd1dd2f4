"""The port's tracking stages against the JAX package's, on a small client map
(``problems.client_map_arrays``, tiny_test_config capacities) and its frames,
handed to both packages as the same arrays.  The two-view bootstrap gets the
RANSAC samples that the JAX key draws.

Tolerances: match and inlier counts, associations and chosen keyframes equal;
poses after pose-only BA within 1e-4 (R) / 1e-3 (t); after the bootstrap's
20-iteration BA, poses within 1e-3 and landmarks within 2e-3 (scale-1 map,
the BA parity bounds of __graft_entry__.py:144-148 on centres)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import tiny_test_config as j_tiny
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.runtime import tracking as jt
from ccm_slam_tpu.runtime.frame import Frame as JFrame
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.config import tiny_test_config
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.runtime import tracking as tt
from ccm_slam_tpu_torch.utils.camera import Camera

CFG, JCFG = tiny_test_config(), j_tiny()
T = torch.as_tensor


def jax_map(fields):
    return jms.MapState(
        kfs=jms.KeyFrameStore(**{k: jnp.asarray(v) for k, v in fields["kfs"].items()}),
        mps=jms.MapPointStore(**{k: jnp.asarray(v) for k, v in fields["mps"].items()}),
        next_kf=jnp.int32(fields["next_kf"]), next_mp=jnp.int32(fields["next_mp"]),
        insert_counter=jnp.int32(fields["insert_counter"]))


def jframe(f):
    return JFrame(**{k: jnp.asarray(v) for k, v in f.items()})


def pframe(f):
    return convert.frame_from_numpy(f, "cpu")


def frame_of_kf(fields, k, with_mp=False):
    kfs = fields["kfs"]
    return dict(timestamp=np.float32(kfs["timestamp"][k]), xy=kfs["xy"][k], desc=kfs["desc"][k],
                octave=kfs["octave"][k], angle=kfs["angle"][k],
                sigma2=(1.2 ** (2 * kfs["octave"][k])).astype(np.float32),
                valid=kfs["feat_valid"][k], R_cw=kfs["R_cw"][k], t_cw=kfs["t_cw"][k],
                mp=kfs["mp_idx"][k] if with_mp else np.full(kfs["mp_idx"].shape[1], -1, np.int32))


@pytest.fixture(scope="module")
def setup():
    fields, frames, poses = problems.client_map_arrays(seed=5)
    m = convert.map_state_from_numpy(fields, "cpu")
    m = ms.compute_distinctive_descriptors(ms.update_normal_and_depth(m, 1.2, 4))
    fields = convert.map_state_to_numpy(m)
    cam_cfg = CFG.camera.__class__(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    return dict(fields=fields, frames=frames, poses=poses,
                cam=Camera.from_config(cam_cfg, "cpu"),
                jcam=JCamera.from_config(JCFG.camera.__class__(k1=0.0, k2=0.0, p1=0.0, p2=0.0)))


def test_match_for_initialization(setup):
    f0, f2 = frame_of_kf(setup["fields"], 0), frame_of_kf(setup["fields"], 2)
    idx, ok, n = tt.match_for_initialization(pframe(f0), pframe(f2), CFG)
    jidx, jok, jn = jt.match_for_initialization(jframe(f0), jframe(f2), JCFG)
    assert int(n) == int(jn) > 50
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(jidx)[ok.numpy()])


@pytest.mark.parametrize("seed,succeeds", [(0, True), (42, False)])
def test_initialize_map_with_jax_samples(setup, seed, succeeds):
    f0, f3 = frame_of_kf(setup["fields"], 0), frame_of_kf(setup["fields"], 5)
    jidx, jok, _ = jt.match_for_initialization(jframe(f0), jframe(f3), JCFG)
    key = jax.random.PRNGKey(seed)
    jm, jf_ref, jf_cur, jsucc, jn = jt.initialize_map(key, jframe(f0), jframe(f3), jidx, jok,
                                                      setup["jcam"], JCFG, client_id=0)
    # the samples initializer.initialize_two_view draws from this key
    kf, kh = jax.random.split(key)
    logits = jnp.log(jok.astype(jnp.float32) + 1e-12)
    idx_f = T(np.array(jax.random.categorical(kf, logits, shape=(200, 8))))
    idx_h = T(np.array(jax.random.categorical(kh, logits, shape=(200, 4))))
    m, f_ref, f_cur, succ, n = tt.initialize_map(
        pframe(f0), pframe(f3), T(np.array(jidx)), T(np.array(jok)), setup["cam"], CFG,
        idx_f=idx_f, idx_h=idx_h)
    assert bool(succ) == bool(jsucc) == succeeds
    assert int(n) == int(jn)
    assert int(n) > 50 or not succeeds
    a, b = convert.map_state_to_numpy(m), convert.map_state_fields(jm)
    for name in ("valid", "bad", "obs_n", "obs_kf", "obs_feat", "ref_kf", "mp_id"):
        np.testing.assert_array_equal(a["mps"][name], b["mps"][name], err_msg=name)
    np.testing.assert_array_equal(a["kfs"]["mp_idx"], b["kfs"]["mp_idx"])
    np.testing.assert_allclose(a["kfs"]["R_cw"], b["kfs"]["R_cw"], atol=1e-3)
    np.testing.assert_allclose(a["kfs"]["t_cw"], b["kfs"]["t_cw"], atol=1e-3)
    alive = b["mps"]["valid"] & ~b["mps"]["bad"]
    np.testing.assert_allclose(a["mps"]["pos"][alive], b["mps"]["pos"][alive], atol=2e-3)
    np.testing.assert_array_equal(f_cur.mp.numpy(), np.asarray(jf_cur.mp))
    np.testing.assert_array_equal(f_ref.mp.numpy(), np.asarray(jf_ref.mp))
    assert ms.check_structure(m) == jms.check_structure(jm)


def close_frames(ours, ref):
    np.testing.assert_array_equal(ours.mp.numpy(), np.asarray(ref.mp))
    np.testing.assert_allclose(ours.R_cw.numpy(), np.asarray(ref.R_cw), atol=1e-4)
    np.testing.assert_allclose(ours.t_cw.numpy(), np.asarray(ref.t_cw), atol=1e-3)


def test_motion_model_and_reference_kf(setup):
    fields = setup["fields"]
    m, jm = convert.map_state_from_numpy(fields, "cpu"), jax_map(fields)
    last = frame_of_kf(fields, 5, with_mp=True)
    (R4, t4), (R5, t5) = setup["poses"][4], setup["poses"][5]
    vel_R = (R5 @ R4.T).astype(np.float32)
    vel_t = (t5 - vel_R @ t4).astype(np.float32)
    cur = setup["frames"][0]
    f2, n_match, n_in = tt.track_with_motion_model(m, pframe(cur), pframe(last), T(vel_R),
                                                   T(vel_t), setup["cam"], CFG)
    jf2, jn_match, jn_in = jt.track_with_motion_model(jm, jframe(cur), jframe(last),
                                                      jnp.asarray(vel_R), jnp.asarray(vel_t),
                                                      setup["jcam"], JCFG)
    assert (int(n_match), int(n_in)) == (int(jn_match), int(jn_in))
    assert int(n_in) > 30
    close_frames(f2, jf2)

    cur_init = dict(cur, R_cw=fields["kfs"]["R_cw"][5], t_cw=fields["kfs"]["t_cw"][5])
    f3, n_match, n_in = tt.track_reference_kf(m, pframe(cur_init), 5, setup["cam"], CFG)
    jf3, jn_match, jn_in = jt.track_reference_kf(jm, jframe(cur_init), jnp.int32(5),
                                                 setup["jcam"], JCFG)
    assert (int(n_match), int(n_in)) == (int(jn_match), int(jn_in))
    assert int(n_match) > 20
    close_frames(f3, jf3)

    R_v, t_v = tt.motion_velocity(f2, pframe(last))
    jR_v, jt_v = jt.motion_velocity(jf2, jframe(last))
    np.testing.assert_allclose(R_v.numpy(), np.asarray(jR_v), atol=1e-4)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(jt_v), atol=1e-3)


def test_track_local_map_and_create_keyframe(setup):
    fields = setup["fields"]
    m, jm = convert.map_state_from_numpy(fields, "cpu"), jax_map(fields)
    # the frame after reference-KF tracking, from the JAX side, given to both
    cur_init = dict(setup["frames"][0], R_cw=fields["kfs"]["R_cw"][5],
                    t_cw=fields["kfs"]["t_cw"][5])
    jf, _, _ = jt.track_reference_kf(jm, jframe(cur_init), jnp.int32(5), setup["jcam"], JCFG)
    fin = {k: np.asarray(getattr(jf, k)) for k in cur_init}
    for wf in (1.0, 3.0):
        m2, f2, n_in, best = tt.track_local_map(m, pframe(fin), setup["cam"], CFG,
                                                window_factor=wf)
        jm2, jf2, jn_in, jbest = jt.track_local_map(jm, jframe(fin), setup["jcam"], JCFG,
                                                    window_factor=wf)
        assert int(n_in) == int(jn_in) > 30 and int(best) == int(jbest)
        close_frames(f2, jf2)
        np.testing.assert_array_equal(m2.mps.n_visible.numpy(), np.asarray(jm2.mps.n_visible))
        np.testing.assert_array_equal(m2.mps.n_found.numpy(), np.asarray(jm2.mps.n_found))

    m3, k = tt.create_keyframe(m2, f2, 6, 0, CFG)
    jm3, jk = jt.create_keyframe(jm2, jframe({n: np.asarray(getattr(f2, n)) for n in fin}),
                                 jnp.int32(6), jnp.int32(0), JCFG)
    assert int(k) == int(jk) == 6
    np.testing.assert_array_equal(m3.mps.obs_kf.numpy(), np.asarray(jm3.mps.obs_kf))
    np.testing.assert_array_equal(m3.mps.obs_n.numpy(), np.asarray(jm3.mps.obs_n))
    assert ms.check_structure(m3) == jms.check_structure(jm3) == []


def test_build_and_apply_ba_problem(setup):
    fields = setup["fields"]
    m, jm = convert.map_state_from_numpy(fields, "cpu"), jax_map(fields)
    K = fields["kfs"]["valid"].shape[0]
    fixed = np.arange(K) == 0
    prob = tt.build_ba_problem(m, setup["cam"], T(fixed))
    jprob = jt.build_ba_problem(jm, setup["jcam"], jnp.asarray(fixed))
    for name in convert.BA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(prob, name)),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
    rng = np.random.RandomState(0)
    R = fields["kfs"]["R_cw"]
    t = fields["kfs"]["t_cw"] + rng.randn(K, 3).astype(np.float32) * 0.01
    X = fields["mps"]["pos"] + 0.01
    moved = np.arange(K) % 2 == 1
    ours = tt.apply_ba_result(m, T(R), T(t), T(X), T(moved))
    ref = jt.apply_ba_result(jm, jnp.asarray(R), jnp.asarray(t), jnp.asarray(X),
                             jnp.asarray(moved))
    for name in ("R_cw", "t_cw", "pose_version"):
        np.testing.assert_array_equal(getattr(ours.kfs, name).numpy(),
                                      np.asarray(getattr(ref.kfs, name)))
    np.testing.assert_array_equal(ours.mps.pos.numpy(), np.asarray(ref.mps.pos))


def test_argmax_ties_take_first_index_like_jax():
    """track_local_map's reference-KF vote: among tied votes the first
    keyframe wins, as jnp.argmax picks it."""
    votes = np.array([-1, 4, 7, 2, 7, 7, -1], np.int32)
    assert int(torch.argmax(T(votes))) == int(jnp.argmax(votes)) == 2
