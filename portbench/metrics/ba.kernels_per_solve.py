"""ba.kernels_per_solve: device operations in the profiler window per traced
solve."""

NAME = "ba.kernels_per_solve"
UNIT = "kernels"
LAYER = "LM driver"
MOVES = "gba_solve_ms"
SOURCE = "device_trace"
PASS = "profile"


def read(ctx):
    return ctx["profile"]["device_ops_n"] / ctx["profile_steps"]
