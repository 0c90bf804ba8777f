"""Port parity: mixed-precision iterative refinement (solve/refine.py) and
the refined driver path (refine=True).

Both packages refine with float32 inner Jacobi-CG and a float64 outer
residual, on the same assembled systems, in float64 on the CPU.  The
float32 inner counts may differ by round-off (the sums run in another
order), so the outer iteration count must be equal, the true float64
relative residual must reach rtol in both, and u must agree within 1e-9
(both are within rtol of the same float64 solution).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.drivers.common import build_reduced_assembler as j_bra
from pfemfort_tpu.drivers.common import solve_implicit as j_solve_implicit
from pfemfort_tpu.dofs.dofmap import build_dofmap as j_build_dofmap
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.solve import refine as jref
from pfemfort_tpu.solve.cg import jacobi_preconditioner as j_jacobi
from pfemfort_tpu.sparse.dia import DIAMatrix as JDIA
from pfemfort_tpu.sparse.ops import operator_and_diag as j_op
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.drivers.common import solve_implicit
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import refine as tref
from pfemfort_tpu_torch.solve.cg import jacobi_preconditioner
from pfemfort_tpu_torch.sparse.ops import operator_and_diag as t_op

torch.set_num_threads(1)


def _jax_system(n):
    mesh, dbc = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = j_build_dofmap(mesh, 1, dbc)
    asm, _ = j_bra(mesh, 1, dofmap, lambda c: j_pem(c, "tetra4", source=-6.0),
                   jnp.float64)
    A, b = asm(jnp.asarray(to_element_minor(mesh.elem_coords())))
    return mesh, dofmap, A, np.array(b)


def _both(A, b, x0=None, **kw):
    """Refine A x = b in both packages: JAX's cg_with_refinement on its
    DIA operators, the port's on the same values carried over."""
    A32 = JDIA(vals=jnp.asarray(np.asarray(A.vals), jnp.float32),
               offsets=A.offsets, n_rows=A.n_rows, lattice=A.lattice)
    op64_j, _ = j_op(A)
    op32_j, d32_j = j_op(A32)
    xj, sj = jref.cg_with_refinement(
        op64_j, op32_j, jnp.asarray(b), precond32=j_jacobi(d32_j),
        x0=None if x0 is None else jnp.asarray(x0), **kw)
    At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                A.lattice, dtype=torch.float64, device="cpu")
    At32 = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                  A.lattice, dtype=torch.float32, device="cpu")
    op64_t, _ = t_op(At)
    op32_t, d32_t = t_op(At32)
    xt, st = tref.cg_with_refinement(
        op64_t, op32_t, torch.as_tensor(b),
        precond32=jacobi_preconditioner(d32_t),
        x0=None if x0 is None else torch.as_tensor(x0), **kw)
    return (np.asarray(xj), sj), (xt, st)


@pytest.mark.parametrize("rtol", [1e-8, 1e-10, 1e-12])
def test_cg_with_refinement_matches_jax(rtol):
    _, _, A, b = _jax_system(6)
    (xj, sj), (xt, st) = _both(A, b, rtol=rtol)
    assert xt.dtype == torch.float64
    assert st.converged and sj.converged and st.relres <= rtol
    assert st.outer_iters == sj.outer_iters >= 2
    assert abs(st.total_inner_iters - sj.total_inner_iters) <= \
        0.1 * sj.total_inner_iters
    assert np.abs(xt.numpy() - xj).max() < 1e-9
    # the reported residual is the true float64 one
    op64, _ = t_op(interop.dia_from_numpy(np.asarray(A.vals), A.offsets,
                                          A.n_rows, A.lattice,
                                          dtype=torch.float64, device="cpu"))
    bt = torch.as_tensor(b)
    true = float(torch.linalg.vector_norm(bt - op64(xt))
                 / torch.linalg.vector_norm(bt))
    assert true == pytest.approx(st.relres, rel=1e-12)


def test_cg_with_refinement_from_x0_and_zero_rhs():
    _, _, A, b = _jax_system(5)
    x0 = np.random.default_rng(0).standard_normal(A.n_rows)
    (xj, sj), (xt, st) = _both(A, b, x0=x0, rtol=1e-10)
    assert st.converged and st.outer_iters == sj.outer_iters
    assert np.abs(xt.numpy() - xj).max() < 1e-9
    x, s = tref.cg_with_refinement(lambda v: v, lambda v: v,
                                   torch.zeros(7, dtype=torch.float64))
    assert s == tref.RefineStats(0, 0, 0.0, True) and not x.any()


def test_cg_with_refinement_stops_at_max_outer():
    _, _, A, b = _jax_system(5)
    (xj, sj), (xt, st) = _both(A, b, rtol=1e-14, max_outer=2)
    assert st.outer_iters == sj.outer_iters == 2
    assert st.converged == bool(sj.converged) is False


@pytest.mark.parametrize("n", [4, 6])
def test_refined_poisson_matches_jax(n):
    jm, jd = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    tm, td = pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, refine=True)
    rt = pt.solve_poisson(tm, td, rtol=1e-10, refine=True,
                          dtype=torch.float32,
                          device="cpu")       # refine ignores dtype
    assert rt.u_reduced.dtype == torch.float64
    assert rt.stats.converged and rt.stats.relres <= 1e-10
    assert rt.timings["outer_iters"] == rj.timings["outer_iters"]
    assert abs(rt.stats.iters - int(rj.stats.iters)) <= \
        0.1 * int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-9
    assert np.abs(rt.u_full - (tm.coords ** 2).sum(1)).max() < 1e-8


def test_refined_solve_on_the_ell_path_matches_jax():
    """A renumbered box: refine skips structure recovery (as in JAX) and
    solves the unordered ELL system; both operators go through the ELL
    product, float64 outside and float32 inside."""
    jm, jd = ft.generate.box_tet(0, 1, 7, 0, 1, 7, 0, 1, 7)
    perm = np.random.default_rng(0).permutation(jm.n_node)
    jm = ft.Mesh(jm.etype, jm.coords, jm.conn).renumbered(perm)
    jd = jd.copy()
    jd[:, 0] = perm[jd[:, 0].astype(np.int64)]
    rj = j_solve_implicit(jm, 1, jd, lambda c: j_pem(c, "tetra4",
                                                     source=-6.0),
                          rtol=1e-10, refine=True)
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    rt = solve_implicit(tm, 1, jd, lambda c: poisson_element_matrices(
        c, "tetra4", source=-6.0), rtol=1e-10, refine=True, device="cpu")
    assert "structure_recovered" not in rt.timings
    assert rt.stats.converged and rt.stats.relres <= 1e-10
    assert rt.timings["outer_iters"] == rj.timings["outer_iters"]
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-9
