"""host_setup.plan_s: the mean over the window's analyses of the program's
span pattern.plan_s inside pattern_s: the assembly plan (its destination
sort runs on the card) and the Dirichlet values of each element slot.  A
span of the host's clock with no synchronise of its own, so the tail of
the card's sort may land in pattern_s's self time.  None where the program
has no such span."""

UNIT, LAYER, MOVES, SOURCE = "s", "host set-up", "analysis_s", "program_span"
KEY = "pattern.plan_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
