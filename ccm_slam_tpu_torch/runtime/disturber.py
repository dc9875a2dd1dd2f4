"""Fault-injecting message channel for communication testing (numpy; the
port's own copy of ``ccm_slam_tpu/runtime/disturber.py``).

The reference's launch files can interpose a network disturber on the map
topics (cslam/launch/Server.launch:8-10, ``dist``); this is that
interposer, deterministic: a seeded channel that drops, delays (and so
reorders) and duplicates MapMsg envelopes between ``publish_client`` /
``pack_vicinity`` and ``ingest`` / ``apply_server_acks``.  For a seed it
delivers in the reference's order (the same ``RandomState`` draws).

The reliability layer it exercises:
* unacked entities are re-sent FULL after ``resend_after`` publish cycles;
* receptions with a missing predecessor or reference are buffered and
  weak-acked (Communicator.cpp:1286-1300 -> SetSendFull);
* duplicate receptions are idempotent and re-acked (Communicator.cpp:830-845);
* entities may only be trimmed once sent AND acked (CanBeForgotten).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ChannelStats:
    sent: int = 0
    dropped: int = 0
    duplicated: int = 0
    delivered: int = 0
    max_seen_delay: int = 0


@dataclass
class DisturbedChannel:
    """One-directional lossy channel.

    ``send(msg)`` enqueues with seeded faults; ``deliver()`` advances one
    cycle and returns the messages due this cycle.  Delayed messages are
    released later than newer undelayed ones — reordering falls out of
    independent per-message delays, exactly like a congested link.
    """

    rng: np.random.RandomState
    p_drop: float = 0.0
    p_dup: float = 0.0
    max_delay: int = 0          # in deliver() cycles
    stats: ChannelStats = field(default_factory=ChannelStats)
    _queue: list = field(default_factory=list)   # (due_cycle, seq, msg)
    _cycle: int = 0
    _seq: int = 0

    def send(self, msg) -> None:
        self.stats.sent += 1
        if self.rng.rand() < self.p_drop:
            self.stats.dropped += 1
            return
        self._enqueue(msg)
        if self.rng.rand() < self.p_dup:
            self.stats.duplicated += 1
            self._enqueue(msg)

    def _enqueue(self, msg) -> None:
        delay = int(self.rng.randint(0, self.max_delay + 1)) if self.max_delay else 0
        self.stats.max_seen_delay = max(self.stats.max_seen_delay, delay)
        self._queue.append((self._cycle + delay, self._seq, msg))
        self._seq += 1

    def deliver(self) -> list:
        """Advance one cycle; return messages due now (arrival order)."""
        due = sorted(
            [q for q in self._queue if q[0] <= self._cycle], key=lambda q: (q[0], q[1])
        )
        self._queue = [q for q in self._queue if q[0] > self._cycle]
        self._cycle += 1
        self.stats.delivered += len(due)
        return [msg for _, _, msg in due]

    def heal(self) -> None:
        """Stop injecting faults (deliver the backlog on subsequent cycles)."""
        self.p_drop = 0.0
        self.p_dup = 0.0
        self.max_delay = 0

    @property
    def pending(self) -> int:
        return len(self._queue)


def make_duplex(seed: int, **kw) -> tuple[DisturbedChannel, DisturbedChannel]:
    """(uplink client->server, downlink server->client) with one seed."""
    rs = np.random.RandomState(seed)
    up = DisturbedChannel(rng=np.random.RandomState(rs.randint(2**31)), **kw)
    down = DisturbedChannel(rng=np.random.RandomState(rs.randint(2**31)), **kw)
    return up, down
