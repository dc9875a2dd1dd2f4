"""The port's lossy in-process channel (``runtime/disturber.py``) against
the JAX package's, and the lossy runs of tests/test_disturber.py on the
ingest side: each client's own messages go through its package's channel
(drop, delay and reorder, duplicate; then healed), both servers ingest what
arrives and must stay equal after every delivery (the comparison of
tests/test_torch_ingest.py: integers exact, poses and positions rtol 1e-5),
and the clients' send states too.  Seeded alike, the port's channel delivers
in JAX's order.
"""

import dataclasses

import pytest

from ccm_slam_tpu.runtime import communicator as jcomm
from ccm_slam_tpu.runtime import disturber as jdist
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime import disturber
from tests.test_torch_communicator import assert_states_equal
from tests.test_torch_ingest import Lockstep


def test_channel_delivers_in_jax_order():
    """The port's channel, seeded as JAX's, drops, delays and duplicates the
    same envelopes and delivers them in the same order."""
    kw = dict(p_drop=0.3, p_dup=0.3, max_delay=3)
    ours, ref = disturber.make_duplex(31, **kw), jdist.make_duplex(31, **kw)
    got, want = [], []
    for i in range(200):
        for a, b in zip(ours, ref):
            a.send(i)
            b.send(i)
            got += a.deliver()
            want += b.deliver()
    assert got == want and len(got) > 0
    assert [dataclasses.astuple(c.stats) for c in ours] == [dataclasses.astuple(c.stats)
                                                            for c in ref]


@pytest.mark.parametrize("seed,kw", [(10, dict(p_drop=0.3)),
                                     (30, dict(p_drop=0.1, p_dup=0.3, max_delay=3))],
                         ids=["drop_resend", "delay_reorder_duplicate"])
def test_lossy_channel_lockstep(seed, kw):
    """tests/test_disturber.py's lossy runs (ingest side): each client's own
    messages go through its package's channel; both servers stay equal
    after every delivery, and the clients' send states too."""
    ls = Lockstep(seed=4)
    chans = [(disturber.make_duplex(seed + a, **kw), jdist.make_duplex(seed + a, **kw))
             for a in range(2)]
    st = [comm.ClientCommState.create(16, 1024) for _ in range(2)]
    jst = [jcomm.ClientCommState.create(16, 1024) for _ in range(2)]
    for cycle in range(12):
        if cycle == 8:
            for pair in chans:
                for up, down in pair:
                    up.heal()
                    down.heal()
        for a in range(2):
            (up, down), (jup, jdown) = chans[a]
            msg, st[a] = comm.publish_client(ls.maps[a], st[a], a, max_kfs=2, max_mps=400)
            jmsg, jst[a] = jcomm.publish_client(ls.jmaps[a], jst[a], a, max_kfs=2, max_mps=400)
            if not jmsg.empty:
                up.send(msg)
                jup.send(jmsg)
            rx, jrx = up.deliver(), jup.deliver()
            assert len(rx) == len(jrx)
            for m_port, m_jax in zip(rx, jrx):
                jack, ack = ls.ingest(a, m_jax, m_port)
                down.send(ack)
                jdown.send(jack)
            for ack, jack in zip(down.deliver(), jdown.deliver()):
                st[a] = comm.apply_server_acks(st[a], ls.maps[a], ack)
                jst[a] = jcomm.apply_server_acks(jst[a], ls.jmaps[a], jack)
            assert_states_equal(st[a], jst[a])
    for a in range(2):
        assert set(ls.ts.agents[a].kf_table) == {0, 1, 2, 3}
        assert st[a].kf_acked[:4].all()
    faults = [(c.stats.dropped, c.stats.duplicated, c.stats.max_seen_delay)
              for pair, _ in chans for c in pair]
    assert sum(map(sum, faults)) > 0
