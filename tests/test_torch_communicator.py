"""The port's communicator against the JAX package's
(``runtime/communicator.py``) on ``build_agent_map`` maps converted with
``convert.map_state_fields``: ``publish_client`` over several cycles (full
sends, pose updates, timeouts and resends), ``apply_server_acks`` with weak
acks, ``trimmable_mask``, ``remap_client_state`` after a compaction and
``ingest_server_map`` of foreign and own entities.  Integers exact; floats
(relative poses, positions) rtol 1e-5 with atol 1e-5 for entries near 0.

Two reference defects are mirrored and named here: ``MapMsg.empty`` raises
on a message without batches, and the foreign tables keep rows that
trimming killed (``communicator.py:97``, ``:447``; ROADMAP section 3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import MappingConfig, SystemConfig
from ccm_slam_tpu.io.synthetic import build_agent_map, make_world
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.runtime import communicator as jcomm
from ccm_slam_tpu.runtime import mapping as jmapping
from ccm_slam_tpu.utils.lie import Sim3 as JSim3
from ccm_slam_tpu.utils.lie import so3_exp
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime import mapping
from tests.test_torch_wire import msg_to_torch

STATE_FIELDS = ("kf_sent", "kf_acked", "mp_sent", "mp_acked", "kf_sent_msg", "mp_sent_msg",
                "kf_from_server", "mp_from_server")


def port_map(jm):
    return convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")


def assert_maps_close(ours, ref, rtol=1e-5, atol=1e-5):
    """Integers and flags exact, floats to rtol/atol (inf where JAX has inf)."""
    a, b = convert.map_state_to_numpy(ours), convert.map_state_fields(ref)
    for sec in ("kfs", "mps"):
        for name, x in a[sec].items():
            y = np.asarray(b[sec][name])
            assert x.shape == y.shape, (sec, name, x.shape, y.shape)
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=f"{sec}.{name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{sec}.{name}")
    for n in ("next_kf", "next_mp", "insert_counter"):
        assert int(a[n]) == int(b[n]), n


def assert_maps_close_past_full_tables(ours, ref):
    """``assert_maps_close``, with the port's declared divergence of the
    batched ingest allowed for (ROADMAP section 3): a link past a landmark's
    full observation table is dropped on both sides, where JAX keeps its
    forward link and adds it up on the table's last slot.  Exactly: each
    forward link of JAX's that the port lacks is -1 in the port, points at
    a landmark whose JAX table is full, and is not in that landmark's
    reverse table in the port; each full landmark lost as many forward links
    as JAX's exceed its table; the reverse tables are JAX's but on a full
    landmark's last slot, where the port holds a forward link to it that
    both maps have; everything else as ``assert_maps_close``."""
    jidx, idx = np.asarray(ref.kfs.mp_idx), ours.kfs.mp_idx.numpy()
    jkf, jfeat = np.asarray(ref.mps.obs_kf), np.asarray(ref.mps.obs_feat)
    kf, feat, n = ours.mps.obs_kf.numpy(), ours.mps.obs_feat.numpy(), ours.mps.obs_n.numpy()
    M, O = kf.shape
    full = np.asarray(ref.mps.obs_n) == O
    k_d, f_d = np.nonzero(idx != jidx)
    np.testing.assert_array_equal(idx[k_d, f_d], -1, err_msg="kfs.mp_idx")
    p_d = jidx[k_d, f_d]
    assert (p_d >= 0).all() and full[p_d].all(), "links dropped from a table with room"
    for k, f, p in zip(k_d, f_d, p_d):
        assert not ((kf[p, :n[p]] == k) & (feat[p, :n[p]] == f)).any(), (k, f, p)
    overflow = np.where(full, np.bincount(jidx[jidx >= 0], minlength=M) - O, 0)
    np.testing.assert_array_equal(np.bincount(p_d, minlength=M), overflow,
                                  err_msg="dropped links per landmark")
    last = np.zeros_like(kf, bool)
    last[:, O - 1] = full
    np.testing.assert_array_equal(np.where(last, jkf, kf), jkf, err_msg="mps.obs_kf")
    np.testing.assert_array_equal(np.where(last, jfeat, feat), jfeat, err_msg="mps.obs_feat")
    for p in np.nonzero(full & ((kf[:, O - 1] != jkf[:, O - 1])
                                | (feat[:, O - 1] != jfeat[:, O - 1])))[0]:
        k, f = kf[p, O - 1], feat[p, O - 1]
        assert jidx[k, f] == p and idx[k, f] == p, p
    ours = ours.replace(kfs=ours.kfs.replace(mp_idx=torch.as_tensor(jidx)),
                        mps=ours.mps.replace(obs_kf=torch.as_tensor(jkf),
                                             obs_feat=torch.as_tensor(jfeat)))
    assert_maps_close(ours, ref)
    return len(p_d)


def assert_msgs_close(ours, ref):
    for name, cls in (("kfs", comm.KFMsgBatch), ("mps", comm.MPMsgBatch)):
        for f in dataclasses.fields(cls):
            x = getattr(getattr(ours, name), f.name).numpy()
            y = np.asarray(getattr(getattr(ref, name), f.name))
            assert x.dtype == y.dtype, (f.name, x.dtype, y.dtype)
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=f"{name}.{f.name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")
    for f in ("ack_kf_ids", "ack_mp_ids"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    for f in ("weak_ack_kf_id", "weak_ack_mp_id", "closest_kf_id", "msg_id"):
        assert getattr(ours, f) == getattr(ref, f), f


def assert_states_equal(ours, ref):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    assert ours.msg_counter == ref.msg_counter and ours.resend_after == ref.resend_after


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(4)
    return make_world(rng, n=300)


@pytest.fixture(scope="module")
def client(world):
    w, d = world
    jm = build_agent_map(w, d, [0.0, 0.7, 1.4, 2.1, 2.8], JSim3.identity(), kf_id_base=0,
                         client_id=0)
    return jm, port_map(jm)


def test_publish_acks_and_resends_match_jax(client):
    jm, m = client
    jst, st = jcomm.ClientCommState.create(16, 1024), comm.ClientCommState.create(16, 1024)
    jst.resend_after = st.resend_after = 2
    # cycle 1: everything is new (budget-limited), then a partial ack with
    # a weak ack that forces a resend of the unacked keyframes
    jmsg, jst = jcomm.publish_client(jm, jst, 0, max_kfs=3, max_mps=300, current_kf_id=4)
    msg, st = comm.publish_client(m, st, 0, max_kfs=3, max_mps=300, current_kf_id=4)
    assert_msgs_close(msg, jmsg)
    assert_states_equal(st, jst)
    ack = jcomm.MapMsg(kfs=None, mps=None, ack_kf_ids=np.array([0, 2, 99], np.int64),
                       ack_mp_ids=np.arange(0, 300, 2, dtype=np.int64), weak_ack_kf_id=1,
                       weak_ack_mp_id=40)
    jst = jcomm.apply_server_acks(jst, jm, ack)
    st = comm.apply_server_acks(st, m, msg_to_torch(ack))
    assert_states_equal(st, jst)
    # the map moves (every pose_version and pos_version + 1): updates for
    # sent keyframes, full sends for the rest, resends after the timeout
    S = JSim3(s=jnp.float32(1.1), R=so3_exp(jnp.array([0.01, 0.02, -0.03])),
              t=jnp.array([0.1, 0.0, -0.2]))
    jm2 = jms.transform_map(jm, S.s, S.R, S.t)
    m2 = ms.transform_map(m, torch.tensor(1.1), torch.as_tensor(np.asarray(S.R)),
                          torch.as_tensor(np.asarray(S.t)))
    for cycle in range(3):
        jmsg, jst = jcomm.publish_client(jm2, jst, 0, max_kfs=3, max_mps=300)
        msg, st = comm.publish_client(m2, st, 0, max_kfs=3, max_mps=300)
        assert_msgs_close(msg, jmsg)
        assert_states_equal(st, jst)
        if cycle == 1:
            full_ack = jcomm.MapMsg(kfs=None, mps=None,
                                    ack_kf_ids=np.asarray(jmsg.kfs.kf_id)[np.asarray(
                                        jmsg.kfs.valid)].astype(np.int64),
                                    ack_mp_ids=np.zeros(0, np.int64))
            jst = jcomm.apply_server_acks(jst, jm2, full_ack)
            st = comm.apply_server_acks(st, m2, msg_to_torch(full_ack))
        np.testing.assert_array_equal(comm.trimmable_mask(m2, st).numpy(),
                                      np.asarray(jcomm.trimmable_mask(jm2, jst)))


def test_remap_client_state_after_compaction_matches_jax(client):
    jm, m = client
    jst, st = jcomm.ClientCommState.create(16, 1024), comm.ClientCommState.create(16, 1024)
    jmsg, jst = jcomm.publish_client(jm, jst, 0, max_kfs=5, max_mps=300)
    _, st = comm.publish_client(m, st, 0, max_kfs=5, max_mps=300)
    ack = jcomm.MapMsg(kfs=None, mps=None, ack_kf_ids=np.array([1, 3], np.int64),
                       ack_mp_ids=np.arange(0, 300, 3, dtype=np.int64))
    jst = jcomm.apply_server_acks(jst, jm, ack)
    st = comm.apply_server_acks(st, m, msg_to_torch(ack))
    jst.kf_from_server[2] = st.kf_from_server[2] = True
    kill = np.zeros(16, bool)
    kill[[0, 2]] = True
    jm_d = jms.erase_keyframes(jm, jnp.asarray(kill))
    m_d = ms.erase_keyframes(m, torch.as_tensor(kill))
    jr = jms.compaction_remap(jm_d)
    r = ms.compaction_remap(m_d)
    for x, y in zip(r, jr):
        np.testing.assert_array_equal(x, y)
    assert_states_equal(comm.remap_client_state(st, *r), jcomm.remap_client_state(jst, *jr))


def test_ingest_server_map_foreign_and_own_match_jax(world, client):
    """Foreign keyframes and landmarks enter the client map; the agent's own
    entities come back as pose updates (alive) or re-instantiations
    (trimmed), flagged from-server; the foreign tables keep the rows that a
    later trim kills (a mirrored reference defect)."""
    w, d = world
    jm, m = client
    jf = build_agent_map(w, d, [1.0, 1.8, 2.6], JSim3(s=jnp.float32(0.8), R=so3_exp(
        jnp.array([0.0, 0.1, 0.0])), t=jnp.array([0.5, 0.0, 0.1])), kf_id_base=30, client_id=2)
    jst0, _ = jcomm.ClientCommState.create(16, 1024), None
    jvic, _ = jcomm.publish_client(jf, jst0, 2, max_kfs=3, max_mps=300)
    jcs, cs = jcomm.ClientCommState.create(16, 1024), comm.ClientCommState.create(16, 1024)
    jfk, jfm, fk, fm = {}, {}, {}, {}
    jm1 = jcomm.ingest_server_map(jm, jvic, 0, jfk, jfm, jcs)
    m1 = comm.ingest_server_map(m, msg_to_torch(jvic), 0, fk, fm, cs)
    assert_maps_close(m1, jm1)
    assert fk == jfk and fm == jfm and len(fk) == 3
    assert_states_equal(cs, jcs)

    # trim the client map to its 3 newest keyframes, then the server hands
    # back the agent's own keyframes (corrected poses, absolute)
    cfg = SystemConfig(mapping=MappingConfig(local_map_size=3))
    jm2, jn, _ = jmapping.trim_keyframes(jm1, cfg)
    m2, n, _ = mapping.trim_keyframes(m1, convert.system_config_from(cfg))
    assert int(n) == int(jn) == 5
    assert_maps_close(m2, jm2)
    jown, _ = jcomm.publish_client(jm, jcomm.ClientCommState.create(16, 1024), 0, max_kfs=5,
                                   max_mps=300)
    jm3 = jcomm.ingest_server_map(jm2, jown, 0, jfk, jfm, jcs)
    m3 = comm.ingest_server_map(m2, msg_to_torch(jown), 0, fk, fm, cs)
    assert_maps_close(m3, jm3)
    assert fk == jfk and fm == jfm
    assert_states_equal(cs, jcs)
    # a second trim keeps the re-instantiated own keyframes and kills the
    # foreign ones: the foreign tables still name them
    jm4, _, _ = jmapping.trim_keyframes(jm3, cfg)
    m4, _, _ = mapping.trim_keyframes(m3, convert.system_config_from(cfg))
    assert_maps_close(m4, jm4)
    alive = (m4.kfs.valid & ~m4.kfs.bad).numpy()
    np.testing.assert_array_equal(alive, np.asarray(jm4.kfs.valid & ~jm4.kfs.bad))
    assert fk == jfk and not any(alive[a] for (c, _), a in fk.items() if c == 2)


def test_ingest_server_map_drops_links_past_a_full_table_like_the_server(world):
    """Vicinity keyframes that see foreign landmarks more often than their 8
    observation slots hold: a foreign agent's 13 keyframes 0.1 apart reach
    a two-keyframe client in messages of 3, 5 and 5; the last ten all see
    the landmarks that came with the first three.  The port drops the links
    past a full table where JAX adds them up on its last slot (the server
    ingest's declared divergence, held to the same rule); the first
    message, which fills no table, compares exactly.  The messages have the
    shapes of the test above, so JAX compiles nothing new."""
    w, d = world
    jm = build_agent_map(w, d, [0.0, 0.7], JSim3.identity(), kf_id_base=0, client_id=0)
    m = port_map(jm)
    jf = build_agent_map(w, d, [1.0 + 0.1 * i for i in range(13)], JSim3.identity(),
                         kf_id_base=30, client_id=2)
    jst = jcomm.ClientCommState.create(16, 1024)
    jcs, cs = jcomm.ClientCommState.create(16, 1024), comm.ClientCommState.create(16, 1024)
    jfk, jfm, fk, fm = {}, {}, {}, {}
    for max_kfs in (3, 5, 5):
        jvic, jst = jcomm.publish_client(jf, jst, 2, max_kfs=max_kfs, max_mps=300)
        jm = jcomm.ingest_server_map(jm, jvic, 0, jfk, jfm, jcs)
        m = comm.ingest_server_map(m, msg_to_torch(jvic), 0, fk, fm, cs)
        if max_kfs == 3:
            assert_maps_close(m, jm)
    assert fk == jfk and fm == jfm and len(fk) == 13
    assert_states_equal(cs, jcs)
    assert assert_maps_close_past_full_tables(m, jm) > 0
    assert jms.check_structure(jm) and ms.check_structure(m) == []


def test_empty_raises_without_batches_like_jax():
    """``MapMsg.empty`` on a message with ``kfs=None`` (what ``pack_vicinity``
    returns when it has nothing to send) raises in both packages."""
    none = dict(kfs=None, mps=None, ack_kf_ids=np.zeros(0, np.int64),
                ack_mp_ids=np.zeros(0, np.int64))
    with pytest.raises(AttributeError):
        jcomm.MapMsg(**none).empty
    with pytest.raises(AttributeError):
        comm.MapMsg(**none).empty
