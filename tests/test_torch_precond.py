"""Port parity: point-block Jacobi, the power-iteration lmax and the
Chebyshev preconditioner (solve/precond.py).

The same assembled systems (built by the JAX package from generated
meshes, some renumbered from a seed so that they take the ELL layout) and
the same residuals (numpy, from a seed) go through both packages in float64
on the CPU.  Each apply must agree with JAX's to 1e-12 of its size; the
Chebyshev-preconditioned solve on the lattice must take JAX's iteration
count with u within 1e-10.  On an ELL system the port solves in its own row
order (drivers/common.py:EllOrdering), so there only a band is held.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.drivers.common import build_reduced_assembler as j_bra
from pfemfort_tpu.dofs.dofmap import build_dofmap as j_build_dofmap
from pfemfort_tpu.elements import elasticity as je
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.solve import precond as jp
from pfemfort_tpu.sparse.dia import DIAMatrix as JDIA
from pfemfort_tpu.sparse.ops import operator_and_diag as j_op
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.drivers.common import solve_implicit
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import precond as tp
from pfemfort_tpu_torch.sparse.ops import operator_and_diag as t_op

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _renumbered(mesh, *tables, seed=0):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    out = []
    for t in tables:
        t = t.copy()
        t[:, 0] = perm[t[:, 0].astype(np.int64)]
        out.append(t)
    return ft.Mesh(mesh.etype, mesh.coords, mesh.conn).renumbered(
        perm.astype(np.int64)), out


def _clamped(mesh):
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def _system(case):
    """(JAX matrix, port matrix, ndof) of one assembled reduced system."""
    if case.startswith("poisson"):
        # a permuted box leaves the DIA census from n = 6 on
        mesh, dbc = ft.generate.box_tet(0, 1, 7, 0, 1, 7, 0, 1, 7)
        ndof, fn = 1, lambda c: j_pem(c, "tetra4", source=-6.0)
    else:
        mesh = ft.generate.rect_tria(0, 2, 8, 0, 1, 4) if "2d" in case \
            else ft.generate.box_tet(0, 1, 3, 0, 1, 2, 0, 1, 2)[0]
        dbc, ndof = _clamped(mesh), mesh.ndim
        D = je.dmat_plane_stress(200.0, 0.3) if ndof == 2 \
            else je.dmat_3d(200.0, 0.3)
        fn = lambda c: je.elasticity_stiffness(c, mesh.etype, D)
    if case.endswith("ell"):
        mesh, (dbc,) = _renumbered(mesh, dbc)
    dofmap = j_build_dofmap(mesh, ndof, dbc)
    asm, _ = j_bra(mesh, ndof, dofmap, fn, jnp.float64)
    A, _ = asm(jnp.asarray(to_element_minor(mesh.elem_coords())))
    if isinstance(A, JDIA):
        At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                    A.lattice, dtype=torch.float64,
                                    device="cpu")
    else:
        At = interop.ell_from_numpy(np.asarray(A.cols), np.asarray(A.vals),
                                    A.n_cols, dtype=torch.float64,
                                    device="cpu")
    assert isinstance(A, JDIA) == case.endswith("dia")
    return A, At, ndof


CASES = ["poisson_dia", "poisson_ell", "el2d_dia", "el2d_ell", "el3d_dia",
         "el3d_ell"]


@pytest.mark.parametrize("case", CASES)
def test_block_jacobi_matches_jax(case):
    A, At, ndof = _system(case)
    r = np.random.default_rng(1).standard_normal(A.n_rows)
    for bs in sorted({1, ndof}):
        zj = jp.block_jacobi_preconditioner(A, bs)(jnp.asarray(r))
        zt = tp.block_jacobi_preconditioner(At, bs)(torch.as_tensor(r))
        assert _rel(zt, zj) < TOL


def test_block_jacobi_refuses_a_misaligned_block():
    _, At, _ = _system("el2d_dia")
    with pytest.raises(ValueError, match="multiple"):
        tp.block_jacobi_preconditioner(At, 3)


@pytest.mark.parametrize("case", CASES)
def test_lmax_and_chebyshev_match_jax(case):
    A, At, _ = _system(case)
    op_j, d_j = j_op(A)
    op_t, d_t = t_op(At)
    lj = float(jp.estimate_lmax_jacobi(op_j, d_j))
    lt = float(tp.estimate_lmax_jacobi(op_t, d_t))
    assert abs(lt - lj) < TOL * lj
    r = np.random.default_rng(2).standard_normal(A.n_rows)
    for degree in (1, 3, 5):
        zj = jp.chebyshev_preconditioner(op_j, d_j, degree=degree)(
            jnp.asarray(r))
        zt = tp.chebyshev_preconditioner(op_t, d_t, degree=degree)(
            torch.as_tensor(r))
        assert _rel(zt, zj) < TOL
    # given bounds (the multigrid coarse tail's form)
    zj = jp.chebyshev_preconditioner(op_j, d_j, lmax=2.5, lmin=0.01,
                                     degree=8)(jnp.asarray(r))
    zt = tp.chebyshev_preconditioner(op_t, d_t, lmax=2.5, lmin=0.01,
                                     degree=8)(torch.as_tensor(r))
    assert _rel(zt, zj) < TOL


@pytest.mark.parametrize("n", [6, 9])
def test_cheby_solve_matches_jax_on_the_lattice(n):
    jm, jd = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    tm, td = pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, precond="cheby")
    rt = pt.solve_poisson(tm, td, rtol=1e-10, precond="cheby",
                          dtype=torch.float64, device="cpu")
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    assert rt.timings["precond_used"] == rt.timings["precond_requested"] \
        == "cheby"
    r_jac = pt.solve_poisson(tm, td, rtol=1e-10, dtype=torch.float64,
                             device="cpu")
    assert rt.stats.iters < r_jac.stats.iters


def test_cheby_solve_on_an_ell_system_is_in_jax_band():
    """Renumbered box, recover=False: the ELL path, solved in the port's
    row order (lex, which restores the lattice's numbering).  The power
    iteration's start vector lives in that order, JAX's in the scrambled
    one, so only a 25% band is held against JAX; against the port's own
    lattice solve of the same box the count is equal to one iteration."""
    jm, jd = ft.generate.box_tet(0, 1, 7, 0, 1, 7, 0, 1, 7)
    jm, (jd,) = _renumbered(jm, jd, seed=3)
    rj = ft.drivers.common.solve_implicit(
        jm, 1, jd, lambda c: j_pem(c, "tetra4", source=-6.0), rtol=1e-10,
        recover=False, precond="cheby")
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    rt = solve_implicit(tm, 1, jd, lambda c: poisson_element_matrices(
        c, "tetra4", source=-6.0), dtype=torch.float64, rtol=1e-10,
        recover=False, precond="cheby", device="cpu")
    assert rt.timings["ordering"] == "lex" and rt.stats.converged
    assert abs(rt.stats.iters - int(rj.stats.iters)) <= \
        0.25 * int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-9
    lm, ld = pt.generate.box_tet(0, 1, 7, 0, 1, 7, 0, 1, 7)
    r_lat = pt.solve_poisson(lm, ld, rtol=1e-10, precond="cheby",
                             dtype=torch.float64, device="cpu")
    assert abs(rt.stats.iters - r_lat.stats.iters) <= 1
