"""ic0_setup_s: the mean IC(0) set-up of the window's analyses, the program's
own stage ic0_setup_s (the values to the host, the CSR, the host library's
factor, T and T^T laid out, routed and copied to the card).  A stage span
of the host's clock that ends in the stage's device synchronise.  None where
the program has no such stage."""

UNIT, LAYER, MOVES, SOURCE = ("s", "preconditioner set-up", "analysis_s",
                              "program_span")
KEY = "ic0_setup_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
