"""The port's multi-agent ``Server`` against the JAX package's on
tests/test_collab_e2e.py's ``collab_run``: two clients of the synthetic
corridor (the second in a scaled and rotated gauge) stream through
``publish_client`` in lockstep (2 keyframes and 400 landmarks a cycle), each
server ingests and runs ``mapping_step`` per new keyframe, then idles into
the final GBA.

RANSAC draws: the JAX server's loop finders split ``PRNGKey(1234 + map)``
and its matcher ``PRNGKey(777)`` once per attempt; the port's
``mapping_step`` gets callables that make the same draws.  Until the merge,
after every ingest and mapping step, both servers hold the same maps, id
tables, pending buffers and banks (integers exact, poses and positions
rtol 1e-5, atol 1e-5); the acks are equal; the merge happens at the same
step and keyframe pair.  After the merge and the final GBA the port meets
tests/test_collab_e2e.py's accuracy, gauge and structure gates, and its
map stays within 1e-3 of JAX's.  The GBA scheduler's own tests are in
tests/test_torch_server_gba.py.
"""

import jax
import numpy as np
import pytest
import torch

from ccm_slam_tpu.runtime import communicator as jcomm
from ccm_slam_tpu.runtime import map_matching as jmm
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.runtime import communicator as comm
from tests.test_torch_communicator import assert_maps_close
from tests.test_torch_ingest import Lockstep
from tests.test_torch_loop_closing import JaxDraws


class MatcherDraws(JaxDraws):
    """The JAX matcher's draws: PRNGKey(777), split once per attempt."""

    def __init__(self):
        super().__init__()
        self.rng = jax.random.PRNGKey(777)


@pytest.fixture(scope="module")
def collab():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small batched products: per-op overhead dominates
    ls = Lockstep(seed=2)
    js, ts = ls.js, ls.ts
    jst = [jcomm.ClientCommState.create(16, 1024) for _ in range(2)]
    st = [comm.ClientCommState.create(16, 1024) for _ in range(2)]
    loop_draws, merge_draws = {0: JaxDraws(0), 1: JaxDraws(1)}, MatcherDraws()
    pairs = {}
    jax_correct_loop, port_try_match = jmm.correct_loop, ts.matcher.try_match

    def jax_pair(m, kf_q, kf_c, *a, **kw):
        pairs.setdefault("jax", (int(kf_q), int(kf_c)))
        return jax_correct_loop(m, kf_q, kf_c, *a, **kw)

    def port_pair(*a, **kw):
        res = port_try_match(*a, **kw)
        if res is not None:
            pairs.setdefault("port", res.kf_pair)
        return res

    jmm.correct_loop, ts.matcher.try_match = jax_pair, port_pair
    events, checked = [], 0
    try:
        for cycle in range(8):
            for a in (0, 1):
                jmsg, jst[a] = jcomm.publish_client(ls.jmaps[a], jst[a], a, max_kfs=2,
                                                    max_mps=400)
                msg, st[a] = comm.publish_client(ls.maps[a], st[a], a, max_kfs=2, max_mps=400)
                if jmsg.empty:
                    continue
                new_ids = [int(i) for i, v in zip(np.asarray(jmsg.kfs.kf_id),
                                                  np.asarray(jmsg.kfs.valid)) if v]
                jack, ack = ls.ingest(a, jmsg, msg)  # compares acks and state
                checked += 1
                jst[a] = jcomm.apply_server_acks(jst[a], ls.jmaps[a], jack)
                st[a] = comm.apply_server_acks(st[a], ls.maps[a], ack)
                for kf_id in new_ids:
                    if kf_id not in js.agents[a].kf_table:
                        continue
                    slot = ts.agents[a].map_slot
                    jout = js.mapping_step(a, js.agents[a].kf_table[kf_id])
                    out = ts.mapping_step(a, ts.agents[a].kf_table[kf_id],
                                          loop_sample=loop_draws[slot], merge_sample=merge_draws)
                    assert out == jout, (cycle, a, kf_id, out, jout)
                    if out[1]:
                        events.append((cycle, a, kf_id))
                    if not events:
                        ls.check()
                        checked += 1
            js.idle_step()
            ts.idle_step()
        for _ in range(js.quiescence_steps + 2):
            js.idle_step()
            ts.idle_step()
    finally:
        jmm.correct_loop, ts.matcher.try_match = jax_correct_loop, port_try_match
        torch.set_num_threads(n)
    return dict(ls=ls, js=js, ts=ts, st=st, jst=jst, events=events, pairs=pairs,
                checked=checked, merge_draws=merge_draws)


def test_servers_equal_until_the_merge_and_merge_at_the_same_pair(collab):
    assert collab["events"], "no merge"
    assert len(collab["events"]) == 1 and collab["checked"] >= 8
    assert collab["pairs"]["port"] == collab["pairs"]["jax"]
    assert len(collab["ts"].maps) == len(collab["js"].maps) == 1
    assert len(collab["merge_draws"].keys) >= 1


def test_acks_and_client_states_equal(collab):
    for a in range(2):
        for f in ("kf_sent", "kf_acked", "mp_sent", "mp_acked"):
            np.testing.assert_array_equal(getattr(collab["st"][a], f),
                                          getattr(collab["jst"][a], f), err_msg=f)
        assert collab["st"][a].kf_acked[:4].all()
    assert (collab["st"][0].mp_sent >= 0).sum() > 50


def test_accuracy_gauge_and_structure_gates(collab):
    """tests/test_collab_e2e.py's gates on the port's server."""
    ts = collab["ts"]
    slot = ts.agents[0].map_slot
    assert ts.agents[1].map_slot == slot
    m = ts.maps[slot]
    centers = m.kfs.center().numpy()
    ids, clients = m.kfs.kf_id.numpy(), m.kfs.client_id.numpy()
    alive = (m.kfs.valid & ~m.kfs.bad).numpy()

    def center_of(client, kf_id):
        hit = np.where(alive & (clients == client) & (ids == kf_id))[0]
        assert len(hit) == 1, (client, kf_id, hit)
        return centers[hit[0]]

    assert np.linalg.norm(center_of(0, 2) - center_of(1, 3)) < 0.15
    assert np.linalg.norm(center_of(0, 3) - center_of(1, 2)) < 0.15
    s0, s1 = float(ts.agents[0].S_map_client.s), float(ts.agents[1].S_map_client.s)
    assert (abs(s0 - 1.0) < 1e-5) != (abs(s1 - 1.0) < 1e-5)
    assert ms.check_structure(m) == []
    # after the merge GBA and the final GBA, still close to JAX's map
    js = collab["js"]
    assert_maps_close(m, js.maps[js.agents[0].map_slot], rtol=1e-3, atol=1e-3)
    for a in range(2):
        ts_t, R, t = ts.trajectory(a)
        jts_t, jR, jt = js.trajectory(a)
        np.testing.assert_array_equal(ts_t, np.asarray(jts_t))
        np.testing.assert_allclose(t, np.asarray(jt), atol=1e-3)


def test_vicinity_matches_jax_and_is_off_by_default(collab):
    ts, js = collab["ts"], collab["js"]
    for a in range(2):
        jmsg = js.pack_vicinity(a, max_kfs=3, max_mps=200)
        msg = ts.pack_vicinity(a, max_kfs=3, max_mps=200)
        for name in ("kfs", "mps"):
            for f in getattr(msg, name).__dataclass_fields__:
                x = getattr(getattr(msg, name), f).numpy()
                y = np.asarray(getattr(getattr(jmsg, name), f))
                if x.dtype.kind == "f":
                    np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-3, err_msg=f)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=f)
    off = ts.pack_vicinity(0)
    assert off.kfs is None and js.pack_vicinity(0).kfs is None
    with pytest.raises(AttributeError):  # MapMsg.empty on kfs=None (mirrored)
        off.empty
