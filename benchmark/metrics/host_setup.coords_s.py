"""host_setup.coords_s: the mean over the window's analyses of the program's
span pattern.coords_s inside pattern_s: the element coordinates
(Mesh.elem_coords, to_element_minor) and the point loads, copied to the
card.  None where the program has no such span."""

UNIT, LAYER, MOVES, SOURCE = "s", "host set-up", "analysis_s", "program_span"
KEY = "pattern.coords_s"


def read(run):
    vals = [u["timings"][KEY] for u in run.timed if KEY in u["timings"]]
    return sum(vals) / len(vals) if vals else None
