"""Seconds of the host factorization (`make_multilevel`) in set-up, by
the harness's clock."""


def read(run):
    return run.system.timings.get("host_fac_s")
