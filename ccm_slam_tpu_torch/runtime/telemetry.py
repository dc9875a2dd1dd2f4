"""Lightweight runtime telemetry: stage timers, counters, health checks.

Counterpart of ``ccm_slam_tpu/runtime/telemetry.py``.  The reference C++'s
observability is coloured couts, a GBA chrono print (Optimizer.cpp:796-801),
per-module line-number checkpoints and a 30 s deadlock watchdog thread
(estd::mylog, estd.h:206-438).  The host loop here cannot deadlock on a
lock, so the watchdog checks *progress*: ``Watchdog.beat(module)``
timestamps each module's last step and ``Watchdog.stalled()`` reports the
modules silent for longer than the threshold.

``StageTimer`` sums wall-clock per pipeline stage (tracking, mapping, GBA,
...) and ``Counters`` is a plain bag of monotonic counters (keyframes
created, landmarks culled, messages sent, ...).  Standard library only.

``StageTimer.sync`` is declared and never read, as in the reference: no
stage synchronises the device, so a stage's wall ends when its host code
returns, not when its kernels finish.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    sync: bool = False  # declared, never read (the reference's flag)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }


@dataclass
class Counters:
    values: dict = field(default_factory=lambda: defaultdict(int))

    def bump(self, name: str, n: int = 1):
        self.values[name] += n

    def get(self, name: str) -> int:
        return self.values[name]

    def summary(self) -> dict:
        return dict(sorted(self.values.items()))


@dataclass
class Watchdog:
    """Module progress monitor: reports stalled pipelines, not locks."""

    threshold_s: float = 30.0
    last_beat: dict = field(default_factory=dict)

    def beat(self, module: str):
        self.last_beat[module] = time.monotonic()

    def stalled(self) -> list:
        now = time.monotonic()
        return [
            (m, round(now - t, 1))
            for m, t in self.last_beat.items()
            if now - t > self.threshold_s
        ]
