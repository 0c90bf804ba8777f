"""krylov_ms_per_iter: the window's Krylov seconds (the program's solve_s)
over its iterations (stats.iters), each summed over the analyses."""

UNIT, LAYER, MOVES, SOURCE = "ms", "Krylov", "analysis_s", "program_span"


def read(run):
    t = [u for u in run.timed if "solve_s" in u["timings"] and u.get("iters")]
    if not t:
        return None
    return 1e3 * sum(u["timings"]["solve_s"] for u in t) / \
        sum(u["iters"] for u in t)
