"""krylov_host_ms_per_iter: the Krylov loop's own host time an iteration,
not waiting on the card: the window's sum of the program's krylov.loop_s
less krylov.wait_s (the time inside the convergence read) over its
iterations (stats.iters; for the 1e-8 entry the inner CG iterations, whose
loops the program sums).  None where the program has no such spans."""

UNIT, LAYER, MOVES, SOURCE = "ms", "Krylov", "analysis_s", "program_span"


def read(run):
    t = [u for u in run.timed
         if "krylov.loop_s" in u["timings"] and u.get("iters")]
    if not t:
        return None
    host = sum(u["timings"]["krylov.loop_s"] - u["timings"]["krylov.wait_s"]
               for u in t)
    return 1e3 * host / sum(u["iters"] for u in t)
