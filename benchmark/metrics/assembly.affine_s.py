"""assembly.affine_s: the mean over the window's analyses of the program's
span assemble.affine_s inside the 1e-8 entry's host_assemble_s: the host's
check that the fine mesh's nodes are an affine box (so its element
coordinates can be made on the card).  None where the program has no such
span."""

UNIT, LAYER, MOVES, SOURCE = "s", "assembly", "analysis_s", "program_span"
KEY = "assemble.affine_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
