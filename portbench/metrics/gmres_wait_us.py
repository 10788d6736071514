"""Microseconds a GMRES iteration the host waits for the Hessenberg
column: the self time of the program's `gmres.read` span (blocked until
the apply and CGS2 finish and the column arrives) over its `gmres.iters`
counter, in the sub-window with the program's tracing on and no profiler
(`portbench/program.py`)."""

from portbench import program


def read(run):
    return program.per_iteration_us(run, "gmres.read")
