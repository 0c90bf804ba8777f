"""ic0_setup.layout_s: the mean over the window's analyses of the program's
span ic0.layout_s inside ic0_setup_s: T and T^T as padded ELL, their routing
(the diagonal census, the DIA form) and their copies to the card.  A span of
the host's clock; the children add no synchronise of their own.  None where
the program has no such span."""

UNIT, LAYER, MOVES, SOURCE = ("s", "preconditioner set-up", "analysis_s",
                              "program_span")
KEY = "ic0.layout_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
