"""Port parity: the full-system float64 solve to a 1e-8 residual
(solve/highprec.py:solve_box_poisson_1e8), against the JAX package's
double-float version, at its own test bars (tests/test_highprec.py there):
box n=16 converged, relres <= 1e-8, <= 6 outer cycles, nodal error < 1e-7;
an uneven 12x16x20 box < 1e-6.  The port builds the system in native
float64 (no stencil, no double-float), so it also must take JAX's outer
count and agree with JAX's u within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.assembly.stencil64 import lattice_bc_f64, \
    stencil_full_system_f64, symmetrized_f32, zero_rows_f64
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.solve.highprec import solve_box_poisson_1e8 as j_1e8
from pfemfort_tpu.solve.multigrid import build_gmg as j_build_gmg
from pfemfort_tpu.sparse.dia import DIAMatrix as JDIA
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve.highprec import full_system_f64, lattice_bc, \
    solve_box_poisson_1e8
from pfemfort_tpu_torch.solve.multigrid import build_gmg, \
    symmetrize_dirichlet

torch.set_num_threads(2)


@pytest.mark.parametrize("args,nodal_bar", [
    ((0, 1, 16, 0, 1, 16, 0, 1, 16), 1e-7),
    ((0, 2, 12, 0, 1, 16, 0, 1, 20), 1e-6)])
def test_solve_1e8_matches_jax(args, nodal_bar):
    jm, jd = ft.generate.box_tet(*args)
    tm, td = pt.generate.box_tet(*args)
    uj, sj, _ = j_1e8(jm, jd, rtol=1e-8)
    ut, st, timings = solve_box_poisson_1e8(tm, td, rtol=1e-8, device="cpu")
    assert st.converged and st.relres <= 1e-8 and st.outer_iters <= 6, st
    assert st.outer_iters == sj.outer_iters
    assert np.abs(ut - (tm.coords ** 2).sum(1)).max() < nodal_bar
    assert np.abs(ut - uj).max() < 1e-9
    assert {"host_assemble_s", "mg_setup_s", "solve_s"} <= set(timings)


def test_full_system_and_fine_level_match_the_jax_stencil():
    """The float64 system assembled on the device equals the JAX package's
    exact stencil with identity BC rows, and the MG fine level its
    symmetrized float32 copy; the hierarchy below it is JAX's."""
    args = (0, 1, 4, 0, 1, 6, 0, 1, 8)
    jm, jd = ft.generate.box_tet(*args)
    tm, td = pt.generate.box_tet(*args)
    offsets, vals, rhs = stencil_full_system_f64(jm)
    mask, bcv = lattice_bc_f64(jm, jd)
    zero_rows_f64(offsets, vals, rhs, mask, bcv)
    tmask, tbcv = lattice_bc(tm, td)
    np.testing.assert_array_equal(tmask, mask)
    fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    A, b, chunks = full_system_f64(tm, fn, torch.as_tensor(tmask),
                                   torch.as_tensor(tbcv), "cpu")
    assert A.offsets == offsets and chunks == 1
    np.testing.assert_allclose(A.vals.numpy(), vals, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(b.numpy(), rhs, rtol=1e-12, atol=1e-13)
    A32 = symmetrize_dirichlet(
        pt.sparse.DIAMatrix(vals=A.vals.float(), offsets=A.offsets,
                            n_rows=A.n_rows), torch.as_tensor(tmask))
    np.testing.assert_array_equal(A32.vals.numpy(),
                                  symmetrized_f32(offsets, vals, mask))
    arrays, meta = build_gmg(tm, 1, tmask, fn, dtype=torch.float32,
                             device="cpu", coarsest_max_dof=64,
                             fine_matrix=A32)
    j_fine = JDIA(vals=jnp.asarray(symmetrized_f32(offsets, vals, mask)),
                  offsets=offsets, n_rows=A.n_rows)
    j_fn = lambda c: j_pem(c, "tetra4", source=-6.0)
    j_arrays, j_meta = j_build_gmg(jm, 1, mask, j_fn, dtype=jnp.float32,
                                   coarsest_max_dof=64, fine_matrix=j_fine)
    assert arrays.mats[0] is A32
    assert [m.n_rows for m in arrays.mats] == \
        [m.n_rows for m in j_arrays.mats] == [315, 60]
    assert meta.shapes == j_meta.shapes
    np.testing.assert_allclose(arrays.mats[1].vals.numpy(),
                               np.asarray(j_arrays.mats[1].vals),
                               rtol=1e-6, atol=1e-6)


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm, td = pt.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_box_poisson_1e8(tm, td)
