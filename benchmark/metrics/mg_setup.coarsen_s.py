"""mg_setup.coarsen_s: the mean over the window's analyses of the program's
span mg.coarsen_s inside mg_setup_s: the multigrid's coarsening chain on
the host (each coarse mesh and its Dirichlet mask).  None where the
program has no such span."""

UNIT, LAYER, MOVES, SOURCE = ("s", "preconditioner set-up", "analysis_s",
                              "program_span")
KEY = "mg.coarsen_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
