"""device_idle_pct.analysis: the share of one traced analysis in which
nothing ran on the card, 1 - (union of device activity) / (the analysis)."""

UNIT, LAYER, MOVES, SOURCE = "%", "device", "analysis_s", "device_trace"


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
