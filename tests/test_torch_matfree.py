"""Port parity: the matrix-free Poisson operator (solve/matfree.py) and
solve_poisson(matrix_free=True), in float64 on the CPU against the JAX
package, on its own matrix-free cases (box_tet and a 2D rect_tria,
tests/test_fullsystem.py there).

The scatter is the port's sorted segment sums, JAX's a segment_sum: the
same sums in another order, so the solutions agree within 1e-10 and CG
takes the same number of iterations; matrix-free against the port's own
assembled solve within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.dofs.dofmap import build_dofmap as j_dofmap
from pfemfort_tpu.elements.basis import tabulate_basis as j_basis
from pfemfort_tpu.elements.geometry import grads_and_det as j_grads, \
    to_element_minor
from pfemfort_tpu.elements.poisson import poisson_matfree_apply as j_apply
from pfemfort_tpu.solve.matfree import make_poisson_matfree_operator as j_mf
from pfemfort_tpu_torch.elements.geometry import grads_and_det
from pfemfort_tpu_torch.elements.poisson import poisson_matfree_apply
from pfemfort_tpu_torch.solve.matfree import make_poisson_matfree_operator

torch.set_num_threads(1)


def _case(kind):
    """(JAX mesh, port mesh, dirichlet, kappa)."""
    if kind == "box_tet":
        args = (0, 1, 6, 0, 1, 6, 0, 1, 6)
        (jm, jd), (tm, _) = ft.generate.box_tet(*args), \
            pt.generate.box_tet(*args)
        return jm, tm, jd, None
    args = (0, 1, 10, 0, 1, 10)
    jm, tm = ft.generate.rect_tria(*args), pt.generate.rect_tria(*args)
    b = ft.generate.boundary_nodes(jm)
    dbc = np.stack([b.astype(float), np.zeros(len(b)),
                    np.sin(np.pi * jm.coords[b, 0])], axis=1)
    return jm, tm, dbc, (1.0, 2.5)


@pytest.mark.parametrize("kind", ["box_tet", "rect_tria"])
def test_element_apply_and_operator_match_jax(kind):
    jm, tm, dbc, kappa = _case(kind)
    ce = to_element_minor(jm.elem_coords())
    rng = np.random.default_rng(0)
    u_e = rng.normal(size=(jm.npe, jm.n_elem))
    _, wts, _, dNdu = j_basis(jm.etype, None)
    kap = np.ones(jm.ndim) if kappa is None else np.asarray(kappa)
    gj, dj = j_grads(jnp.asarray(ce), dNdu)
    yj = j_apply(jnp.asarray(u_e), gj, jnp.asarray(wts)[:, None] * dj,
                 jnp.asarray(kap), af=1.5)
    gt, dt = grads_and_det(torch.as_tensor(ce), dNdu)
    yt = poisson_matfree_apply(torch.as_tensor(u_e), gt,
                               torch.as_tensor(wts)[:, None] * dt,
                               torch.as_tensor(kap), af=1.5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-13,
                               atol=1e-13)

    dm = j_dofmap(jm, 1, dbc)
    op_j, diag_j = j_mf(jnp.asarray(ce), jm.etype, dm, kappa=kappa)
    op_t, diag_t = make_poisson_matfree_operator(torch.as_tensor(ce),
                                                 tm.etype, dm, kappa=kappa)
    x = rng.normal(size=dm.total_dof)
    scale = np.abs(np.asarray(op_j(jnp.asarray(x)))).max()
    assert np.abs(op_t(torch.as_tensor(x)).numpy()
                  - np.asarray(op_j(jnp.asarray(x)))).max() < 1e-13 * scale
    np.testing.assert_allclose(diag_t.numpy(), np.asarray(diag_j),
                               rtol=1e-13)


@pytest.mark.parametrize("kind", ["box_tet", "rect_tria"])
def test_matrix_free_solve_matches_jax_and_the_assembled_solve(kind):
    jm, tm, dbc, kappa = _case(kind)
    rj = ft.solve_poisson(jm, dbc, kappa=kappa, rtol=1e-11,
                          matrix_free=True)
    rt = pt.solve_poisson(tm, dbc, kappa=kappa, rtol=1e-11, matrix_free=True,
                          dtype=torch.float64, device="cpu")
    assert rt.stats.converged and bool(rj.stats.converged)
    assert rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    assert set(rt.timings) == {"pattern_s", "assemble_s", "solve_s"}
    ra = pt.solve_poisson(tm, dbc, kappa=kappa, rtol=1e-11,
                          dtype=torch.float64, device="cpu")
    assert abs(ra.stats.iters - rt.stats.iters) <= 1
    assert np.abs(rt.u_full - ra.u_full).max() < 1e-9


def test_matrix_free_float32_and_nodal_exactness():
    """box_tet Poisson with source -6 is nodally exact for x^2+y^2+z^2;
    the float32 matrix-free solve reaches it to float32 accuracy."""
    tm, dbc = pt.generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    r = pt.solve_poisson(tm, dbc, rtol=1e-6, matrix_free=True,
                         dtype=torch.float32, device="cpu")
    assert r.stats.converged and r.u_reduced.dtype == torch.float32
    assert np.abs(r.u_full - (tm.coords ** 2).sum(1)).max() < 2e-5
