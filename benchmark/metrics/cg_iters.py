"""cg_iters: the program's CG iterations (stats.iters) per analysis, the
mean over the window: it shows whether a gain came from fewer
iterations."""

UNIT, LAYER, MOVES, SOURCE = "count", "Krylov", "analysis_s", \
    "program_counter"


def read(run):
    t = [u["iters"] for u in run.timed if u.get("iters")]
    return sum(t) / len(t) if t else None
