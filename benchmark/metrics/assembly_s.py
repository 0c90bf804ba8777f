"""assembly_s: the mean assembly of the window's analyses, the program's own
assemble_s (host_assemble_s for the 1e-8 entry: the float64 system built
on the card, despite its name)."""

UNIT, LAYER, MOVES, SOURCE = "s", "assembly", "analysis_s", "program_span"


def read(run):
    vals = [u["timings"].get("assemble_s", u["timings"].get("host_assemble_s"))
            for u in run.timed]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
