"""tracking.local_map_ms: median host-clock wall of
``tracking.track_local_map`` per call, the device synchronised before and
after."""

import statistics

NAME = "tracking.local_map_ms"
UNIT = "ms"
LAYER = "tracking stages"
MOVES = "frames_per_s"
SOURCE = "program_span"
PASS = "spans"
SPAN = ("ccm_slam_tpu_torch.runtime.tracking", "track_local_map")


def _median(ctx):
    ms = ctx.get("spans", {}).get(NAME) or []
    return statistics.median(ms) if ms else None


def read(ctx):
    return _median(ctx)
