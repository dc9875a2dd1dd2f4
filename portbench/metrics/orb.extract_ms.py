"""orb.extract_ms: median host-clock wall of ``orb.extract`` per call, the
device synchronised before and after."""

import statistics

NAME = "orb.extract_ms"
UNIT = "ms"
LAYER = "extractor"
MOVES = "frames_per_s"
SOURCE = "program_span"
PASS = "spans"
SPAN = ("ccm_slam_tpu_torch.ops.orb", "extract")


def _median(ctx):
    ms = ctx.get("spans", {}).get(NAME) or []
    return statistics.median(ms) if ms else None


def read(ctx):
    return _median(ctx)
