"""The share of the device's idle time that lies under the solver's round
trip: in the profiled sub-window with the program's tracing on
(`portbench/program.py`), the idle time under the innermost program span
`gmres.read`, `gmres.givens`, `gmres.update` or `gmres.residual`, over
all of it (the rest lies under `gmres.apply`, `gmres.orth`, `plan.apply`,
`kr.apply` or outside every span)."""

from portbench import program


def read(run):
    block = program.windows(run)
    if not block or block["busy_s"] <= 0:
        return None
    return block["round_trip_idle_pct"]
