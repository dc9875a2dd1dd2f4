"""tracker.frame_p95_ms: 95th percentile of the host-clock wall of each window
frame, the device synchronised after each frame."""

import statistics

NAME = "tracker.frame_p95_ms"
UNIT = "ms"
LAYER = "client loop"
MOVES = "frames_per_s"
SOURCE = "host_clock"
PASS = "spans"


def read(ctx):
    ms = ctx.get("step_ms") or []
    return statistics.quantiles(ms, n=20)[18] if len(ms) >= 2 else None
