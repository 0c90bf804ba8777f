"""Entry `box_1e8`: one analysis through the port's
solve_box_poisson_1e8 (the float64 full system assembled on the card,
GMG-preconditioned float32 inner CG, float64 outer refinement to a true
relative residual of the mix's "rtol"), on a generated box, Poisson only.

Handed to the reference: the load, the Dirichlet values and the returned u.
"""

NUMBER = "relres_full"   # numbers/relres_full.py
RESUMES = False


def run(traffic, load: dict, steps=None) -> dict:
    from pfemfort_tpu_torch.solve.highprec import solve_box_poisson_1e8
    u, stats, timings = solve_box_poisson_1e8(
        traffic.port_mesh(), traffic.dirichlet(load),
        rtol=traffic.mix["rtol"], source=traffic.physics.source(load),
        device=traffic.device, **traffic.mix.get("options", {}))
    return dict(answer=u, timings=dict(timings),
                iters=int(stats.total_inner_iters),
                outer_iters=int(stats.outer_iters),
                converged=bool(stats.converged))
