"""The port's batched server ingest (``runtime/ingest.py`` through
``Server.ingest``) against the JAX package's, message by message.

Both servers start from the setup of tests/test_disturber.py (two
``build_agent_map`` clients, the second in a scaled and rotated gauge, a
256-word vocabulary trained by JAX and converted) and ingest the same
messages: JAX's ``publish_client`` output, carried into the port field by
field.  After every message the acks, the server maps, the id dicts and
device tables, the pending buffers and both place-recognition banks are
compared: integers exact, poses and positions rtol 1e-5 (atol 1e-5 for
entries near 0), BoW vectors to 1e-6.  Cases: predecessors out of order
(pending, then resolved), the parent fallback, weak acks, in-batch
duplicates and growth beyond the initial arena.  The lossy channel of
tests/test_disturber.py drives the same comparison in
tests/test_torch_disturber.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ccm_slam_tpu.config import CameraConfig, CapacityConfig, PlaceRecConfig, SystemConfig
from ccm_slam_tpu.io.synthetic import N_FEAT, build_agent_map, make_world
from ccm_slam_tpu.ops import bow as jbow
from ccm_slam_tpu.runtime import communicator as jcomm
from ccm_slam_tpu.runtime import ingest as jing
from ccm_slam_tpu.runtime.server import Server as JServer
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu.utils.lie import SE3 as JSE3
from ccm_slam_tpu.utils.lie import Sim3 as JSim3
from ccm_slam_tpu.utils.lie import so3_exp
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.config import CameraConfig as TCameraConfig
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime import ingest as ing
from ccm_slam_tpu_torch.runtime.server import Server
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_torch_communicator import assert_maps_close, assert_maps_close_past_full_tables
from tests.test_torch_wire import msg_to_torch


def jax_cfg():
    return SystemConfig(
        capacity=CapacityConfig(max_keypoints=N_FEAT, client_max_kfs=16, client_max_mps=1024,
                                server_max_kfs=32, server_max_mps=2048, max_obs_per_mp=8),
        placerec=PlaceRecConfig(start_map_matching_after_kf=0))


def rows_msg(jmsg, kf_rows, mp_rows=None):
    """A JAX message of 2 keyframe rows and 400 landmark rows picked from
    ``jmsg`` (-1: an invalid row): every message of this file has the
    shapes of the lossy runs, so JAX compiles its ingest once."""
    def pick(batch, rows, n):
        rows = list(rows) + [-1] * (n - len(rows))
        idx = jnp.asarray([max(r, 0) for r in rows])
        live = jnp.asarray([r >= 0 for r in rows])
        out = jax.tree.map(lambda x: x[idx], batch)
        return out.replace(valid=out.valid & live)
    mp_rows = [] if mp_rows is None else mp_rows
    return dataclasses.replace(jmsg, kfs=pick(jmsg.kfs, kf_rows, 2),
                               mps=pick(jmsg.mps, mp_rows, 400))


class Lockstep:
    """A JAX server and the port's on the same clients and vocabulary."""

    def __init__(self, seed=2, xs=((0.0, 1.0, 2.0, 3.0), (5.0, 4.0, 3.0, 2.0)), kf_cap=16):
        rng = np.random.RandomState(seed)
        world, wdesc = make_world(rng, n=300)
        self.jcfg = jax_cfg()
        jcam = JCamera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0))
        vocab = jbow.train_vocabulary(jax.random.PRNGKey(0), jnp.asarray(wdesc),
                                      jnp.ones(len(wdesc), bool), n_words=256, iters=6)
        gauge1 = JSim3(s=jnp.float32(1.4), R=so3_exp(jnp.array([0.0, 0.0, -0.04])),
                       t=jnp.array([0.3, 0.1, -0.2]))
        gauges = (JSim3.identity(), gauge1)
        self.jmaps = [build_agent_map(world, wdesc, list(x), gauges[a], kf_id_base=0,
                                      client_id=a, kf_cap=kf_cap) for a, x in enumerate(xs)]
        self.maps = [convert.map_state_from_numpy(convert.map_state_fields(m), "cpu")
                     for m in self.jmaps]
        n = len(xs)
        self.js = JServer(cfg=self.jcfg, cam=jcam, vocab=vocab, n_agents=n)
        self.ts = Server(cfg=convert.system_config_from(self.jcfg),
                         cam=Camera.from_config(TCameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0),
                                                "cpu"),
                         vocab=convert.vocabulary_from_numpy(convert.vocabulary_fields(vocab),
                                                             "cpu"),
                         n_agents=n, device="cpu")

    def ingest(self, agent, jmsg, msg=None):
        """Both servers ingest one message (the port's own, or JAX's carried
        over); the acks and the whole server state are compared."""
        jack = self.js.ingest(agent, jmsg)
        ack = self.ts.ingest(agent, msg_to_torch(jmsg) if msg is None else msg)
        np.testing.assert_array_equal(ack.ack_kf_ids, jack.ack_kf_ids)
        np.testing.assert_array_equal(ack.ack_mp_ids, jack.ack_mp_ids)
        assert (ack.weak_ack_kf_id, ack.weak_ack_mp_id) == (jack.weak_ack_kf_id,
                                                            jack.weak_ack_mp_id)
        self.check()
        return jack, ack

    def check(self):
        js, ts = self.js, self.ts
        assert sorted(ts.maps) == sorted(js.maps)
        for slot in js.maps:
            assert_maps_close_past_full_tables(ts.maps[slot], js.maps[slot])
            for name in ("vectors", "valid", "map_id"):
                np.testing.assert_allclose(getattr(ts.finders[slot].db, name).numpy(),
                                           np.asarray(getattr(js.finders[slot].db, name)),
                                           atol=1e-6, err_msg=name)
        for name in ("vectors", "valid", "map_id"):
            np.testing.assert_allclose(getattr(ts.matcher.db, name).numpy(),
                                       np.asarray(getattr(js.matcher.db, name)), atol=1e-6,
                                       err_msg=name)
        assert ts.matcher.kf_capacity == js.matcher.kf_capacity
        for a, jag in js.agents.items():
            ag = ts.agents[a]
            assert (ag.map_slot, ag.kf_table, ag.mp_table, ag.last_data_step) == (
                jag.map_slot, jag.kf_table, jag.mp_table, jag.last_data_step)
            if jag.ing_tables is None:
                assert ag.ing_tables is None
                continue
            for f in ("kf_id2arena", "mp_id2arena", "max_kf_id", "max_mp_id"):
                np.testing.assert_array_equal(getattr(ag.ing_tables, f).numpy(),
                                              np.asarray(getattr(jag.ing_tables, f)), err_msg=f)
            for pend, jpend, cls in ((ag.pending_kfb, jag.pending_kfb, comm.KFMsgBatch),
                                     (ag.pending_mpb, jag.pending_mpb, comm.MPMsgBatch)):
                for f in dataclasses.fields(cls):
                    x, y = getattr(pend, f.name).numpy(), np.asarray(getattr(jpend, f.name))
                    np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=f.name)
        assert ts.gba_progress == js.gba_progress and ts.gba_dirty == js.gba_dirty


def test_empty_tables_match_jax():
    for spaces in ((), (64, 1000)):
        ours, ref = ing.empty_tables(*spaces, device="cpu"), jing.empty_tables(*spaces)
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
            assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert ing.empty_tables(device="cpu").kf_id2arena.shape == (1 << 16,)


def test_out_of_order_predecessors_pending_then_resolved():
    """Keyframes 2 and 3 before their predecessors: pending (weak-acked),
    then the root and keyframe 1 resolve the chain in order."""
    ls = Lockstep(seed=5)
    jmsg, _ = jcomm.publish_client(ls.jmaps[0], jcomm.ClientCommState.create(16, 1024), 0,
                                   max_kfs=4, max_mps=400)
    ls.ingest(0, rows_msg(jmsg, [3, 2]))
    assert int(torch.sum(ls.ts.agents[0].pending_kfb.valid)) == 2
    ls.ingest(0, rows_msg(jmsg, [0]))  # the absolute root
    ls.ingest(0, rows_msg(jmsg, [1], range(400)))  # the chain resolves 2 and 3 in order
    assert set(ls.ts.agents[0].kf_table) == {0, 1, 2, 3}


def test_parent_fallback_when_predecessor_never_arrives():
    """Keyframe 1 is lost for good; keyframe 2 names it as predecessor and
    keyframe 0 as parent, and lands through the parent."""
    ls = Lockstep(seed=7)
    m0 = ls.jmaps[0]
    jmsg, _ = jcomm.publish_client(m0, jcomm.ClientCommState.create(16, 1024), 0, max_kfs=4,
                                   max_mps=400)
    ids = np.asarray(m0.kfs.kf_id)
    k, p = int(np.where(ids == 2)[0][0]), int(np.where(ids == 0)[0][0])
    T_rel = JSE3(R=m0.kfs.R_cw[k], t=m0.kfs.t_cw[k]).compose(
        JSE3(R=m0.kfs.R_cw[p], t=m0.kfs.t_cw[p]).inverse())
    item2 = rows_msg(jmsg, [2])
    item2 = dataclasses.replace(item2, kfs=item2.kfs.replace(
        par_kf_id=item2.kfs.par_kf_id.at[0].set(0), R_cpar=item2.kfs.R_cpar.at[0].set(T_rel.R),
        t_cpar=item2.kfs.t_cpar.at[0].set(T_rel.t)))
    ls.ingest(0, rows_msg(jmsg, [0]))
    jack, _ = ls.ingest(0, item2)
    assert 2 in ls.ts.agents[0].kf_table and 2 in set(jack.ack_kf_ids.tolist())
    ls.ingest(0, rows_msg(jmsg, [3], range(400)))
    assert 3 in ls.ts.agents[0].kf_table


def test_weak_acks_and_in_batch_duplicates():
    """A pose update for a keyframe the server never saw (weak ack), then a
    message holding every keyframe and landmark twice (the first copy of a
    landmark id lands, the keyframe copies become updates)."""
    ls = Lockstep(seed=4)
    jm = ls.jmaps[1]
    jmsg, _ = jcomm.publish_client(jm, jcomm.ClientCommState.create(16, 1024), 1, max_kfs=2,
                                   max_mps=400)
    upd = dataclasses.replace(jmsg, kfs=jmsg.kfs.replace(full=jnp.zeros_like(jmsg.kfs.full)),
                              mps=jmsg.mps.replace(full=jnp.zeros_like(jmsg.mps.full)))
    jack, _ = ls.ingest(1, upd)
    assert jack.weak_ack_kf_id == -1 and jack.weak_ack_mp_id == -1  # nothing known yet
    n_mp = int(jnp.sum(jmsg.mps.valid))
    half = list(range(min(n_mp, 200)))
    ls.ingest(1, rows_msg(jmsg, [0, 0], half + half))  # every row twice
    jack, _ = ls.ingest(1, rows_msg(jmsg, [1, 1], half + half))
    jack, _ = ls.ingest(1, upd)  # now known: pose updates, acked
    assert len(jack.ack_kf_ids) == 2


def test_growth_beyond_the_initial_arena():
    """tests/test_grow.py's stream, at this file's shapes: 29 keyframes into
    a server whose arena starts at 32 slots; it grows at 27 (and the shared
    bank re-grids) in step.  The keyframes overflow landmarks' observation
    tables: the port drops the links past them where JAX adds them up (a
    declared divergence, allowed for by
    ``assert_maps_close_past_full_tables``)."""
    ls = Lockstep(seed=2, xs=([0.1 * i for i in range(29)], [5.0]), kf_cap=32)
    jst = jcomm.ClientCommState.create(32, 1024)
    for _ in range(16):
        jmsg, jst = jcomm.publish_client(ls.jmaps[0], jst, 0, max_kfs=2, max_mps=400)
        if jmsg.empty:
            break
        jack, _ = ls.ingest(0, jmsg)
        jst = jcomm.apply_server_acks(jst, ls.jmaps[0], jack)
    assert ls.ts.maps[0].kfs.capacity == 64 and ls.ts.matcher.kf_capacity == 64
    assert set(ls.ts.agents[0].kf_table) == set(range(29))
    # 29 keyframes 0.1 apart see each landmark more often than its 8 slots
    # hold: JAX adds the links past them up, the port drops them
    from ccm_slam_tpu.models import map_store as jms
    from ccm_slam_tpu_torch.models import map_store as ms

    assert jms.check_structure(ls.js.maps[0]) and ms.check_structure(ls.ts.maps[0]) == []


def test_landmark_on_a_culled_reference_keyframe_is_reanchored_where_jax_keeps_it_dead():
    """Keyframe 1 is culled on the server after it landed; then landmarks
    whose reference keyframe is 1 arrive.  JAX lands them with the dead
    reference (``check_structure`` reports each); the port anchors each at
    its first observer in the batch, and retires one that has none (a
    declared divergence).  Everything else stays equal."""
    from ccm_slam_tpu.models import map_store as jms
    from ccm_slam_tpu_torch.models import map_store as ms

    ls = Lockstep(seed=5)
    jmsg, _ = jcomm.publish_client(ls.jmaps[0], jcomm.ClientCommState.create(16, 1024), 0,
                                   max_kfs=4, max_mps=400)
    ref = np.asarray(jmsg.mps.ref_kf_id)
    valid = np.asarray(jmsg.mps.valid)
    ls.ingest(0, rows_msg(jmsg, [0, 1], np.where(valid & (ref == 0))[0]))
    dead = np.zeros(32, bool)
    dead[ls.ts.agents[0].kf_table[1]] = True
    ls.js.maps[0] = jms.erase_keyframes(ls.js.maps[0], jnp.asarray(dead))
    ls.ts.maps[0] = ms.erase_keyframes(ls.ts.maps[0], torch.as_tensor(dead))
    on_dead = np.where(valid & (ref == 1))[0]
    assert len(on_dead) > 10
    msg_b = rows_msg(jmsg, [2, 3], on_dead)
    ls.js.ingest(0, msg_b)
    ls.ts.ingest(0, msg_to_torch(msg_b))
    jm, m = ls.js.maps[0], ls.ts.maps[0]
    jerr = jms.check_structure(jm)
    assert jerr and all("reference keyframe" in e for e in jerr)
    assert ms.check_structure(m) == []
    moved = np.asarray(jm.mps.ref_kf) != m.mps.ref_kf.numpy()
    assert moved.sum() == len(jerr)
    seen = moved & (m.mps.obs_n.numpy() > 0)
    np.testing.assert_array_equal(m.mps.ref_kf.numpy()[seen], m.mps.obs_kf.numpy()[seen, 0])
    np.testing.assert_array_equal(m.mps.bad.numpy()[moved], ~seen[moved])
    assert seen.sum() > 0
    m = m.replace(mps=m.mps.replace(ref_kf=torch.as_tensor(np.asarray(jm.mps.ref_kf)),
                                    bad=torch.as_tensor(np.asarray(jm.mps.bad))))
    assert_maps_close(m, jm)
