"""device.idle_share.gba: share of the profiler window in which no operation
ran on the device (1 minus the union of the device's operation intervals)."""

NAME = "device.idle_share.gba"
UNIT = "%"
LAYER = "device"
MOVES = "gba_solve_ms"
SOURCE = "device_trace"
PASS = "profile"


def read(ctx):
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
