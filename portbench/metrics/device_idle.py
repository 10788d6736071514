"""The share of the traced window in which no device activity runs
(kernels, copies, memsets: the union of their intervals)."""


def read(run):
    t = run.traced
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
