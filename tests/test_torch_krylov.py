"""Port parity: BiCGStab and restarted GMRES.

Both solvers of both packages run on the same operators and right-hand
sides, made from a seed with numpy, in float64 on the CPU: dense
nonsymmetric matrices (Jacobi-preconditioned or not, from zero or from a
given x0) and the assembled Poisson and elasticity systems through
`solve_implicit(method=...)`.  Each must take the JAX package's iteration
count and reach its solution to a relative 1e-10 of the solution's size
(BiCGStab on elasticity: see its test).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.drivers.elasticity import solve_elasticity as j_solve_el
from pfemfort_tpu.solve.cg import bicgstab_solve as j_bicgstab
from pfemfort_tpu.solve.cg import jacobi_preconditioner as j_jacobi
from pfemfort_tpu.solve.gmres import gmres_solve as j_gmres
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.solve.cg import bicgstab_solve, \
    jacobi_preconditioner
from pfemfort_tpu_torch.solve.gmres import gmres_solve

torch.set_num_threads(1)

X_TOL = 1e-10


def _system(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + np.sqrt(n) * np.diag(
        rng.uniform(1.0, 3.0, n))
    return A, rng.standard_normal(n), rng.standard_normal(n)


def _run(solver, A, b, x0, precond, **kw):
    if solver == "gmres":
        jfn, tfn = j_gmres, gmres_solve
    else:
        jfn, tfn = j_bicgstab, bicgstab_solve
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    d = np.diag(A).copy()
    xj, sj = jfn(lambda v: Aj @ v, jnp.asarray(b),
                 x0=None if x0 is None else jnp.asarray(x0),
                 precond=j_jacobi(jnp.asarray(d)) if precond else None, **kw)
    xt, st = tfn(lambda v: At @ v, torch.as_tensor(b),
                 x0=None if x0 is None else torch.as_tensor(x0),
                 precond=jacobi_preconditioner(torch.as_tensor(d))
                 if precond else None, **kw)
    return (np.asarray(xj), sj), (xt.numpy(), st)


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
@pytest.mark.parametrize("n,precond,use_x0", [(50, False, False),
                                              (120, True, False),
                                              (200, True, True)])
def test_dense_nonsymmetric_matches_jax(solver, n, precond, use_x0):
    A, b, x0 = _system(n, seed=n)
    kw = dict(rtol=1e-10, maxiter=2000)
    if solver == "gmres":
        kw["restart"] = 20
    (xj, sj), (xt, st) = _run(solver, A, b, x0 if use_x0 else None, precond,
                              **kw)
    assert st.converged and bool(sj.converged)
    assert st.iters == int(sj.iters)
    assert abs(st.relres - float(sj.relres)) <= 1e-3 * float(sj.relres)
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
    assert np.abs(A @ xt - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_maxiter_stops_like_jax(solver):
    A, b, _ = _system(80, seed=3)
    (xj, sj), (xt, st) = _run(solver, A, b, None, False, rtol=1e-14,
                              maxiter=7)
    assert not st.converged and not bool(sj.converged)
    assert st.iters == int(sj.iters)
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
@pytest.mark.parametrize("dims", [(4, 4, 4), (6, 5, 7)])
def test_solve_poisson_with_method_matches_jax(method, dims):
    args = (0, 1, dims[0], 0, 1, dims[1], 0, 1, dims[2])
    (jm, jd), (tm, td) = ft.generate.box_tet(*args), pt.generate.box_tet(*args)
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, method=method)
    rt = pt.solve_poisson(tm, td, rtol=1e-10, method=method,
                          dtype=torch.float64, device="cpu")
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() <= 1e-9


def test_solve_elasticity_bicgstab_matches_jax():
    mesh = ft.generate.rect_tria(0, 2, 8, 0, 1, 4)
    left = np.nonzero(mesh.coords[:, 0] == 0.0)[0]
    right = np.nonzero(mesh.coords[:, 0] == 2.0)[0]
    dbc = np.array([[n, c, 0.0] for n in left for c in (0, 1)])
    fbc = np.array([[n, 1, -1.0] for n in right])
    rj = j_solve_el(mesh, dbc, 240.565, 0.3, force_bc=fbc, rtol=1e-10,
                    method="bicgstab")
    tm = interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn,
                                 mesh.structure)
    rt = pt.solve_elasticity(tm, dbc, 240.565, 0.3, force_bc=fbc, rtol=1e-10,
                             method="bicgstab", dtype=torch.float64,
                             device="cpu")
    # BiCGStab's count on an elasticity system moves by up to 2 when b
    # changes by a relative 1e-15, in the JAX package alone (dense against
    # DIA operator, or b perturbed)
    assert rt.stats.converged
    assert abs(rt.stats.iters - int(rj.stats.iters)) <= 2
    # BiCGStab's residual is not monotone: two runs that differ in round-off
    # stop at different points inside the rtol ball, 1e-8 of the solution
    assert np.abs(rt.u_full - rj.u_full).max() <= 1e-8 * np.abs(
        rj.u_full).max()


def test_unknown_method_is_refused():
    tm, td = pt.generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 3)
    with pytest.raises(ValueError, match="method"):
        pt.solve_poisson(tm, td, method="minres", device="cpu")
