"""Port parity: Jacobi-preconditioned CG.

A system assembled by the JAX package is carried into the port with
`interop.dia_from_numpy`; both solvers run in float64 on the CPU and must
take the same number of iterations to the same relres and solution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.assembly import structured as jst
from pfemfort_tpu.dofs.dofmap import build_dofmap, full_lattice, reduced_box
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices
from pfemfort_tpu.mesh import generate
from pfemfort_tpu.solve import cg as jcg
from pfemfort_tpu.sparse.ops import operator_and_diag as j_operator_and_diag
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.solve import cg as tcg
from pfemfort_tpu_torch.sparse.ops import operator_and_diag

torch.set_num_threads(1)

# Both run the same recurrence in float64; only the summation order of the
# dot products differs.
TOL = 1e-10


def _jax_system(n):
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc)
    Ke, Fe = poisson_element_matrices(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4",
        source=-6.0)
    plan = jst.build_structured_plan(n, n, n)
    return jst.reduce_structured_system(
        jst.assemble_dia_structured(Ke, plan),
        jst.assemble_rhs_structured(Fe, plan), reduced_box(mesh, dofmap),
        full_lattice(mesh), jnp.asarray(dofmap.bc_values_full))


def _both(A, b, **kw):
    op_j, diag_j = j_operator_and_diag(A)
    uj, sj = jcg.cg_solve(op_j, b, precond=jcg.jacobi_preconditioner(diag_j),
                          **kw)
    At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                A.lattice, dtype=torch.float64, device="cpu")
    op_t, diag_t = operator_and_diag(At)
    ut, st = tcg.cg_solve(op_t, torch.tensor(np.asarray(b)),
                          precond=tcg.jacobi_preconditioner(diag_t), **kw)
    return (np.asarray(uj), sj), (ut.numpy(), st)


def _rel_diff(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("n,rtol", [(5, 1e-8), (7, 1e-8), (7, 1e-11),
                                    (9, 1e-6)])
def test_cg_same_iterations_relres_and_solution(n, rtol):
    A, b = _jax_system(n)
    (uj, sj), (ut, st) = _both(A, b, rtol=rtol)
    assert st.iters == int(sj.iters)
    assert st.converged and bool(sj.converged)
    assert _rel_diff(st.relres, float(sj.relres)) < TOL
    assert np.abs(ut - uj).max() / np.abs(uj).max() < TOL


def test_cg_maxiter_and_x0_match():
    A, b = _jax_system(7)
    x0 = np.random.default_rng(0).standard_normal(A.n_rows)
    (uj, sj), (ut, st) = _both(A, b, rtol=1e-12, maxiter=9)
    assert st.iters == int(sj.iters) == 9
    assert not st.converged and not bool(sj.converged)
    assert np.abs(ut - uj).max() / np.abs(uj).max() < TOL

    op_j, diag_j = j_operator_and_diag(A)
    uj, sj = jcg.cg_solve(op_j, b, x0=jnp.asarray(x0), rtol=1e-9,
                          precond=jcg.jacobi_preconditioner(diag_j))
    At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                A.lattice, dtype=torch.float64, device="cpu")
    op_t, diag_t = operator_and_diag(At)
    x0_t = torch.as_tensor(x0)
    ut, st = tcg.cg_solve(op_t, torch.tensor(np.asarray(b)), x0=x0_t,
                          rtol=1e-9, precond=tcg.jacobi_preconditioner(diag_t))
    np.testing.assert_array_equal(x0_t.numpy(), x0)   # x0 is not modified
    assert st.iters == int(sj.iters)
    assert np.abs(ut.numpy() - np.asarray(uj)).max() < TOL


def test_cg_zero_rhs_and_atol_match():
    A, b = _jax_system(5)
    (uj, sj), (ut, st) = _both(A, jnp.zeros_like(b))
    assert st.iters == int(sj.iters) == 0
    assert st.relres == float(sj.relres) == 0.0 and st.converged
    np.testing.assert_array_equal(ut, np.zeros(A.n_rows))
    (uj, sj), (ut, st) = _both(A, b, rtol=0.0, atol=1e-7)
    assert st.iters == int(sj.iters) and st.converged


def test_cg_without_preconditioner_matches():
    A, b = _jax_system(6)
    op_j, _ = j_operator_and_diag(A)
    uj, sj = jcg.cg_solve(op_j, b, rtol=1e-9)
    At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                A.lattice, dtype=torch.float64, device="cpu")
    op_t, _ = operator_and_diag(At)
    ut, st = tcg.cg_solve(op_t, torch.tensor(np.asarray(b)), rtol=1e-9)
    assert st.iters == int(sj.iters)
    assert np.abs(ut.numpy() - np.asarray(uj)).max() < TOL


def test_jacobi_preconditioner_matches_with_zero_diagonal():
    rng = np.random.default_rng(2)
    diag = rng.standard_normal(50)
    diag[[3, 17]] = 0.0
    r = rng.standard_normal(50)
    zj = jcg.jacobi_preconditioner(jnp.asarray(diag))(jnp.asarray(r))
    zt = tcg.jacobi_preconditioner(torch.as_tensor(diag))(torch.as_tensor(r))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
