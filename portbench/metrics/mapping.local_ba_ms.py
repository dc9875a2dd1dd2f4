"""mapping.local_ba_ms: median host-clock wall of ``mapping.local_ba`` per
keyframe, the device synchronised before and after."""

import statistics

NAME = "mapping.local_ba_ms"
UNIT = "ms"
LAYER = "local mapping"
MOVES = "frames_per_s"
SOURCE = "program_span"
PASS = "spans"
SPAN = ("ccm_slam_tpu_torch.runtime.mapping", "local_ba")


def _median(ctx):
    ms = ctx.get("spans", {}).get(NAME) or []
    return statistics.median(ms) if ms else None


def read(ctx):
    return _median(ctx)
