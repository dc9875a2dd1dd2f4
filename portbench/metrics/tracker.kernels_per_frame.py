"""tracker.kernels_per_frame: device operations in the profiler window over the
frames traced."""

NAME = "tracker.kernels_per_frame"
UNIT = "kernels"
LAYER = "client loop"
MOVES = "frames_per_s"
SOURCE = "device_trace"
PASS = "profile"


def read(ctx):
    return ctx["profile"]["device_ops_n"] / ctx["profile_steps"]
