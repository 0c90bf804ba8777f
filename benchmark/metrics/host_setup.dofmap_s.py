"""host_setup.dofmap_s: the mean over the window's analyses of the program's
span pattern.dofmap_s inside pattern_s: both DOF maps (build_dofmap, the
second with the element tables) on the host.  None where the program has
no such span."""

UNIT, LAYER, MOVES, SOURCE = "s", "host set-up", "analysis_s", "program_span"
KEY = "pattern.dofmap_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
