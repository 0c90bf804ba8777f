"""step_ms: time per explicit step, the whole window over the steps of the
blocks completed in it."""

UNIT, SOURCE = "ms", "host_clock"


def read(run):
    steps = sum(u.get("steps", 0) for u in run.units)
    return 1e3 * run.window_s / steps if steps else None
