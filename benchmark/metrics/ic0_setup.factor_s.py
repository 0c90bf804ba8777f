"""ic0_setup.factor_s: the mean over the window's analyses of the program's
span ic0.factor_s inside ic0_setup_s: the CSR's lower triangle, the host
library's IC(0) factor and 1/diag(L).  A span of the host's clock; the
children add no synchronise of their own.  None where the program has no
such span."""

UNIT, LAYER, MOVES, SOURCE = ("s", "preconditioner set-up", "analysis_s",
                              "program_span")
KEY = "ic0.factor_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
