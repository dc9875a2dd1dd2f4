"""ba.cg_steps_per_solve: CG steps per traced solve: the program's
``schur_off`` launches less one per LM iteration
(``ops.ba_kernels.LAUNCHES``)."""

NAME = "ba.cg_steps_per_solve"
UNIT = "steps"
LAYER = "LM driver"
MOVES = "gba_solve_ms"
SOURCE = "program_counter"
PASS = "profile"


def read(ctx):
    return float(ctx["counters"]["cg_steps"])
