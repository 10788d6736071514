"""GMRES iterations a solve, averaged over the window's solves (the
program's own count, `GmresResult.num_iter`)."""


def read(run):
    iters = run.state.get("iters")
    return sum(iters) / len(iters) if iters else None
