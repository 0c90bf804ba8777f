"""device_idle_pct.explicit: the share of one traced block of explicit
steps in which nothing ran on the card, 1 - (union of device activity) /
(the block)."""

UNIT, LAYER, MOVES, SOURCE = "%", "device", "step_ms", "device_trace"


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
