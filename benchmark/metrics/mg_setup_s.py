"""mg_setup_s: the mean multigrid set-up of the window's analyses, the
program's own mg_setup_s."""

UNIT, LAYER, MOVES, SOURCE = ("s", "preconditioner set-up", "analysis_s",
                              "program_span")


def read(run):
    vals = [u["timings"]["mg_setup_s"] for u in run.timed
            if "mg_setup_s" in u["timings"]]
    return sum(vals) / len(vals) if vals else None
