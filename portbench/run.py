"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding the port (``ccm_slam_tpu_torch``) on a
machine with an NVIDIA card.  ``BENCHMARK.json`` names the cells; each cell
is a configuration (``portbench/configs``), a traffic file
(``portbench/traffic``, naming its kind of cell in ``portbench/cells``) and,
with ``--trace 1``, the per-layer metric readers of ``portbench/metrics``.

A run sets up (makes or loads its inputs from the seed, builds and warms
the program), measures ``--seconds`` of closed-loop work, checks what the
window produced against the plain references of ``portbench/reference``,
prints each compared number beside its limit on standard error and the
result as the last line of standard output.  ``--trace 1`` reports the
per-layer metrics instead, from a window with wall spans and a profiler
window.

Caches stay in the checkout: the CUDA kernels are built by the port into
``build/ccm_slam_tpu_torch/`` on the first run; the client's rendered
frames are kept as uint8 ``.npy`` files under ``portbench/.cache/frames/``
(72 MB for the world's 200 frames at 752x480; each seed adds its own
sensor noise on the card), so a later run loads them.  That cache is all
a run writes.

The limits of the check come from ``calibrate.py`` (the program's readings
over seeds, the control's and planted faults'); the GBA maps take their
shape from the client's own map (``map_stats.py``).  CPU tests:
``python -m pytest portbench -q -p no:randomly -n 0`` (card tests skip
without one).  A run needs no network and imports neither JAX nor the
JAX package.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
