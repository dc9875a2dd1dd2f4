"""ba_kernels_roofline: the BA kernels' summed bound time
(``portbench.counts``: bytes at 3.35 TB/s or float32 operations at 67
TFLOP/s, per launch counted by ``ops.ba_kernels.LAUNCHES``) over their
summed device time in the profiler window."""

from portbench import counts

NAME = "ba_kernels_roofline"
UNIT = "%"
LAYER = "BA kernels"
MOVES = "gba_solve_ms"
SOURCE = "device_trace"
PASS = "profile"


def read(ctx):
    c = ctx["counters"]
    measured = sum(v for k, v in ctx["profile"]["time_by_kernel"].items()
                   if k.split("::")[-1] in counts.BA_KERNEL_NAMES)
    if measured <= 0:
        return None
    return 100.0 * counts.launches_bound_s(c["launches"], *c["shape"]) / measured
