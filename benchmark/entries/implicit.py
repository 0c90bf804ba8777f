"""Entry `implicit`: one analysis through the port's implicit driver of the
configuration's physics (solve_poisson / solve_elasticity), from the mesh
arrays on the host to the returned solution.

The mix gives "dtype", "rtol" and "options" (passed through).  Handed to the
reference: the load, the Dirichlet values it implies and the returned
u_full.  An analysis counts as failed when the program reports it
unconverged.
"""

NUMBER = "relres"      # numbers/relres.py
RESUMES = False        # a failed unit leaves the next one as it was


def run(traffic, load: dict, steps=None) -> dict:
    mix = traffic.mix
    res = traffic.physics.solve(traffic, load, dtype=traffic.dtype,
                                rtol=mix["rtol"], **mix.get("options", {}))
    return dict(answer=res.u_full, timings=dict(res.timings),
                iters=int(res.stats.iters),
                converged=bool(res.stats.converged))
