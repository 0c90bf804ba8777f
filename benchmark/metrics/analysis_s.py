"""analysis_s: time to solution of one analysis, the whole window over the
analyses completed in it (one mean, so a stall anywhere shows; the window
ends with the analysis that crosses --seconds)."""

UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.window_s / len(run.units) if run.units else None
