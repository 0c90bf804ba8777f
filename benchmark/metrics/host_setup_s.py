"""host_setup_s: the mean host set-up of the window's analyses, the program's
own stage timings pattern_s + order_s (mesh to DOF map, pattern or
structured plan, element coordinates to the card; ELL row ordering)."""

UNIT, LAYER, MOVES, SOURCE = "s", "host set-up", "analysis_s", "program_span"


def read(run):
    t = [u["timings"] for u in run.timed if "pattern_s" in u["timings"]]
    if not t:
        return None
    return sum(x["pattern_s"] + x.get("order_s", 0.0) for x in t) / len(t)
