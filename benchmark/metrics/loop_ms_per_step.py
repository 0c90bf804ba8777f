"""loop_ms_per_step: the explicit time loop's milliseconds a step over the
window's blocks: the sum of the program's span explicit.loop_s (from the
first step to the last chunk's probe copy to the host) over the sum of
their steps.  The records are explicit_setup_s's (the program's RECENT,
with the warm-up and the traced block left out).  None where the program
keeps no such record."""

from benchmark.harness import registry

UNIT, LAYER, MOVES, SOURCE = "ms", "time loop", "step_ms", "program_span"


def read(run):
    t = registry.module("metrics", "explicit_setup_s").window_records(run)
    if not t:
        return None
    return 1e3 * sum(x["explicit.loop_s"] for x in t) / \
        sum(x["steps"] for x in t)
