"""Milliseconds of device time of one Kapur-Rokhlin corrector apply in the
traced window (everything launched inside the program's
`KrAccumCorrector.apply`, divided by its calls)."""


def read(run):
    span = run.traced.spans.get("corrector") if run.traced else None
    if not span or span["device_s"] <= 0:
        return None
    return 1e3 * span["device_s"] / span["calls"]
