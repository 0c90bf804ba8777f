"""host_reads_per_iter: the blocking device-to-host reads of the Krylov
solves an iteration: the window's sum of the program's krylov.host_reads
(one per loop test and the final statistics; the 1e-8 entry adds its outer
cycles' reads) over its iterations (stats.iters).  None where the program
has no such counter."""

UNIT, LAYER, MOVES, SOURCE = "count", "Krylov", "analysis_s", \
    "program_counter"


def read(run):
    t = [u for u in run.timed
         if "krylov.host_reads" in u["timings"] and u.get("iters")]
    if not t:
        return None
    return sum(u["timings"]["krylov.host_reads"] for u in t) / \
        sum(u["iters"] for u in t)
