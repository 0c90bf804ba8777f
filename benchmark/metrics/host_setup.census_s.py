"""host_setup.census_s: the mean over the window's analyses of the program's
span pattern.census_s inside pattern_s: build_pattern on the host (the
offset census, the rhs destinations, the ELL layout).  A span of the
host's clock with no synchronise of its own.  None where the program has
no such span."""

UNIT, LAYER, MOVES, SOURCE = "s", "host set-up", "analysis_s", "program_span"
KEY = "pattern.census_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
