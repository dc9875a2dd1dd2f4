"""device.idle_share.client: share of the profiler window in which no operation
ran on the device (1 minus the union of the device's operation intervals)."""

NAME = "device.idle_share.client"
UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"
SOURCE = "device_trace"
PASS = "profile"


def read(ctx):
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
