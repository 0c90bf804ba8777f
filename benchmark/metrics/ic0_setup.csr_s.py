"""ic0_setup.csr_s: the mean over the window's analyses of the program's span
ic0.csr_s inside ic0_setup_s: the assembled values copied to the host and
the host CSR (the host library's one pass over the DIA matrix).  A span of
the host's clock; the children add no synchronise of their own.  None where
the program has no such span."""

UNIT, LAYER, MOVES, SOURCE = ("s", "preconditioner set-up", "analysis_s",
                              "program_span")
KEY = "ic0.csr_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
