"""Entry `implicit_precond`: entries/implicit.py's analysis, held to the
preconditioner the mix names in its "options" ("precond").  The program
reports the one that ran (timings["precond_used"], Jacobi when it reports
none); an analysis that ran another raises, so a program that does not
carry the cell's preconditioner fails at the warm-up, before the window,
and is never timed as if it had run it.  Handed to the reference: what
entries/implicit.py hands it.
"""

from benchmark.harness import registry

NUMBER = "relres"      # numbers/relres.py
RESUMES = False        # a failed unit leaves the next one as it was


def run(traffic, load: dict, steps=None) -> dict:
    unit = registry.module("entries", "implicit").run(traffic, load, steps)
    asked = traffic.mix.get("options", {}).get("precond", "jacobi")
    ran = unit["timings"].get("precond_used", "jacobi")
    if ran != asked:
        raise RuntimeError(f"the program ran precond {ran!r} where the mix "
                           f"asks for {asked!r}")
    return unit
