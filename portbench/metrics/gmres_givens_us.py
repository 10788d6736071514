"""Microseconds of the host's Givens step a GMRES iteration: the self
time of the program's `gmres.givens` span over its `gmres.iters` counter,
in the sub-window with the program's tracing on and no profiler
(`portbench/program.py`)."""

from portbench import program


def read(run):
    return program.per_iteration_us(run, "gmres.givens")
