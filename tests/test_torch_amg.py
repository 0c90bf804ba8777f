"""Port parity: smoothed-aggregation AMG (solve/amg.py), its host
aggregation (csrc/host_native.cpp) and the device routing of its blocks
(solve/amg_device.py).

The same CSR matrices (assembled by the JAX package; a renumbered box and a
scrambled Delaunay mesh permuted into the port's ELL row order, as its
solve builds them) go into both packages in float64 on the CPU.  The
aggregates must be IDENTICAL; the hierarchy's level sizes equal and every
block (level operators, P, P^T, P0, P0^T), omega, inverse diagonal and the
dense coarsest inverse within 1e-12; one V-cycle within 1e-12 of both JAX
forms (`samg_preconditioner`, `samg_device_preconditioner`), also on a
JAX-built hierarchy carried over with `interop.samg_from_numpy`; the
AMG-preconditioned solves take JAX's iteration count on the lattice.
"""

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import jax.numpy as jnp

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.drivers.common import build_reduced_assembler as j_bra
from pfemfort_tpu.drivers.common import solve_implicit as j_solve_implicit
from pfemfort_tpu.dofs.dofmap import build_dofmap as j_build_dofmap
from pfemfort_tpu.elements import elasticity as je
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.solve import amg as jamg
from pfemfort_tpu.solve import amg_device as jad
from pfemfort_tpu.solve import ic0 as jic
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler, solve_implicit
from pfemfort_tpu_torch.elements import elasticity as te
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import amg as tamg
from pfemfort_tpu_torch.solve import amg_device as tad
from pfemfort_tpu_torch.solve import ic0 as tic
from pfemfort_tpu_torch.sparse.spmv import spmv_ell

torch.set_num_threads(1)

TOL = 1e-12
POISSON_T = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
POISSON_J = lambda c: j_pem(c, "tetra4", source=-6.0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _scrambled(n, seed=0):
    mesh, dbc = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return ft.Mesh(mesh.etype, mesh.coords, mesh.conn).renumbered(perm), dbc


def _delaunay(n, seed=0):
    """Delaunay tets of a jittered (n+1)^3 lattice, nodes scrambled; u =
    x^2+y^2+z^2 on the hull (as tests/test_amg.py)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    conn[vol6 < 0] = conn[vol6 < 0][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    hull = np.unique(tri.convex_hull)
    perm = rng.permutation(len(pts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(pts))
    dbc = np.stack([perm[hull], np.zeros(len(hull)),
                    (pts[hull] ** 2).sum(1)], 1)
    return ft.Mesh("tetra4", pts[inv], perm[conn].astype(np.int32)), dbc


def _ordered_csr(mesh, dbc):
    """CSR of an ELL system permuted into the port's solve row order."""
    tm = interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn)
    dofmap = pt.build_dofmap(tm, 1, dbc)
    asm = build_reduced_assembler(tm, 1, dofmap, POISSON_T, torch.float64,
                                  "cpu")
    assert asm.pattern.layout == "ell"
    A, _ = asm(torch.as_tensor(to_element_minor(tm.elem_coords())))
    ordering = build_ell_ordering(asm.pattern, tm.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, "cpu")
    indptr, indices, vals, n = tic._csr_from_matrix(A, asm.pattern)
    return (*tad.permute_csr(indptr, indices, vals, ordering.order.numpy()),
            n)


def _elasticity_box(n):
    mesh, _ = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[b, d, 0.0] for b in base for d in (0, 1, 2)])
    fbc = np.array([[int(np.argmax(mesh.coords.sum(axis=1))), 0, 1.0]])
    return mesh, dbc, fbc


def _csr(case):
    """(indptr, indices, vals, n, ndof) of one SPD system."""
    if case == "scrambled":
        return (*_ordered_csr(*_scrambled(12)), 1)
    if case == "delaunay":
        return (*_ordered_csr(*_delaunay(12, seed=2)), 1)
    if case == "box":
        mesh, dbc = ft.generate.box_tet(0, 1, 12, 0, 1, 12, 0, 1, 12)
        ndof, fn = 1, POISSON_J
    else:
        mesh, dbc, _ = _elasticity_box(6)
        ndof = 3
        fn = lambda c: je.elasticity_stiffness(c, "tetra4",
                                               je.dmat_3d(210.0, 0.3))
    dofmap = j_build_dofmap(mesh, ndof, dbc)
    asm, _ = j_bra(mesh, ndof, dofmap, fn, jnp.float64)
    A, _ = asm(jnp.asarray(to_element_minor(mesh.elem_coords())))
    return (*jic._csr_from_matrix(A, getattr(asm, "pattern", None)), ndof)


CASES = ["box", "elasticity", "scrambled", "delaunay"]


def _random_graph(n=500, seed=3):
    rng = np.random.default_rng(seed)
    ii, jj = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    keep = ii != jj
    S = ssp.csr_matrix((np.ones(keep.sum(), np.float32),
                        (ii[keep], jj[keep])), shape=(n, n))
    return ((S + S.T) > 0).astype(np.float32).tocsr()


@pytest.mark.parametrize("double", [False, True])
def test_aggregation_is_identical_to_jax(double):
    S = _random_graph()
    fj = jamg._aggregate2 if double else jamg._aggregate
    ft_ = tamg._aggregate2 if double else tamg._aggregate
    agg_j, na_j = fj(S.indptr, S.indices.astype(np.int64), S.shape[0])
    agg_t, na_t = ft_(S.indptr, S.indices.astype(np.int64), S.shape[0])
    assert na_t == na_j and na_t < S.shape[0]
    np.testing.assert_array_equal(agg_t, agg_j)


def test_nullspace_and_tentative_prolongator_match_jax():
    rng = np.random.default_rng(4)
    n_node = 60
    coords = rng.random((n_node, 3))
    rows_node = np.repeat(np.arange(n_node), 3)
    comp = np.tile(np.arange(3), n_node)
    Bj = jamg._rigid_body_modes(coords[rows_node], comp, 3)
    Bt = tamg._rigid_body_modes(coords[rows_node], comp, 3)
    np.testing.assert_array_equal(Bt, Bj)
    agg = rng.integers(0, 12, n_node)[rows_node]
    P0j, Bcj = jamg._tentative_from_nullspace(agg, 12, Bj)
    P0t, Bct = tamg._tentative_from_nullspace(agg, 12, Bt)
    assert abs(P0t - P0j).max() < TOL and _rel(Bct, Bcj) < TOL


def _assert_ell_equal(blk, cols, vals):
    np.testing.assert_array_equal(blk.cols.numpy(), np.asarray(cols))
    assert _rel(blk.vals.numpy(), vals) < TOL


def _hierarchies(case, **kw):
    indptr, indices, vals, n, ndof = _csr(case)
    jb = jamg.build_samg(indptr, indices, vals, n, ndof=ndof,
                         dtype=jnp.float64, **kw)
    tb = tamg.build_samg(indptr, indices, vals, n, ndof=ndof,
                         dtype=torch.float64, **kw, device="cpu")
    return jb, tb


@pytest.mark.parametrize("case", CASES)
def test_build_samg_matches_jax(case):
    (ja, jmeta), (ta, tmeta) = _hierarchies(case)
    assert tmeta.sizes == tuple(jmeta.sizes) and len(tmeta.sizes) >= 2
    assert (tmeta.nu, tmeta.omega_smooth) == (jmeta.nu, jmeta.omega_smooth)
    for name in ("a", "p", "pt", "p0", "p0t"):
        for blk, c, v in zip(getattr(ta, name), getattr(ja, name + "_cols"),
                             getattr(ja, name + "_vals")):
            _assert_ell_equal(blk, c, v)
    np.testing.assert_allclose(ta.omegas, ja.omegas, rtol=TOL)
    for dt, dj in zip(ta.inv_diags, ja.inv_diags):
        assert _rel(dt, dj) < TOL
    assert _rel(ta.coarse_inv, ja.coarse_inv) < 1e-10


def test_build_samg_with_nodal_blocks_and_nullspace_matches_jax():
    """node_block = 3 with rigid-body modes: the SA recursion over a
    carried near-nullspace."""
    mesh, dbc, _ = _elasticity_box(6)
    indptr, indices, vals, n, _ = _csr("elasticity")
    dofmap = j_build_dofmap(mesh, 3, dbc)
    rows = dofmap.assy_for_soln
    B = jamg._rigid_body_modes(mesh.coords[rows // 3], rows % 3, 3)
    kw = dict(ndof=3, node_block=3, nullspace=B)
    ja, jmeta = jamg.build_samg(indptr, indices, vals, n, dtype=jnp.float64,
                                **kw)
    ta, tmeta = tamg.build_samg(indptr, indices, vals, n,
                                dtype=torch.float64, **kw, device="cpu")
    assert tmeta.sizes == tuple(jmeta.sizes) and len(tmeta.sizes) >= 2
    for blk, c, v in zip(ta.p0, ja.p0_cols, ja.p0_vals):
        _assert_ell_equal(blk, c, v)
    for blk, c, v in zip(ta.a, ja.a_cols, ja.a_vals):
        _assert_ell_equal(blk, c, v)


@pytest.mark.parametrize("case", CASES)
def test_vcycle_matches_both_jax_forms(case):
    (ja, jmeta), (ta, tmeta) = _hierarchies(case)
    n = tmeta.sizes[0]
    r = np.random.default_rng(6).standard_normal(n)
    z_port = np.asarray(jamg.samg_preconditioner(ja, jmeta)(jnp.asarray(r)))
    jdev = jad.build_samg_device(ja, jmeta.sizes, dtype=jnp.float64)
    z_dev = np.asarray(jad.samg_device_preconditioner(jdev, jmeta)(
        jnp.asarray(r)))
    assert _rel(z_dev, z_port) < TOL
    carried, cmeta = interop.samg_from_numpy(ja, jmeta, dtype=torch.float64,
                                             device="cpu")
    tdev = tad.build_samg_device(ta, tmeta.sizes, dtype=torch.float64,
                                 device="cpu")
    fine = tad.build_samg_device(ta, tmeta.sizes, dtype=torch.float64,
                                 external_fine_op=True, device="cpu")
    assert fine.ops[0] is None
    spmv0 = lambda x: spmv_ell(ta.a[0], x)
    rt = torch.as_tensor(r)
    for z in (tamg.samg_preconditioner(ta, tmeta)(rt),
              tamg.samg_preconditioner(carried, cmeta)(rt),
              tad.samg_device_preconditioner(tdev, tmeta)(rt),
              tad.samg_device_preconditioner(fine, tmeta, spmv0)(rt)):
        assert _rel(z, z_port) < TOL and _rel(z, z_dev) < TOL
    with pytest.raises(ValueError, match="spmv0"):
        tad.samg_device_preconditioner(fine, tmeta)


@pytest.mark.parametrize("n", [12, 14])
def test_amg_solve_matches_jax_on_the_lattice(n):
    jm, jd = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    tm, td = pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, precond="amg")
    rt = pt.solve_poisson(tm, td, rtol=1e-10, precond="amg",
                          dtype=torch.float64, device="cpu")
    assert rj.timings["precond_used"] == "amg"
    assert rt.timings["precond_used"] == "amg"
    assert rt.timings["amg_levels"][0] == (n - 1) ** 3
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10


def test_amg_elasticity_matches_jax():
    """solve_implicit(ndof=3, precond='amg') on a clamped, loaded box
    (882 dofs: above the 800-row coarsest size, so a hierarchy builds)."""
    jm, dbc, fbc = _elasticity_box(6)
    rj = j_solve_implicit(jm, 3, dbc, lambda c: je.elasticity_stiffness(
        c, "tetra4", je.dmat_3d(210.0, 0.3)), force_bc=fbc, rtol=1e-10,
        precond="amg")
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn, jm.structure)
    rt = solve_implicit(tm, 3, dbc, lambda c: te.elasticity_stiffness(
        c, "tetra4", te.dmat_3d(210.0, 0.3)), force_bc=fbc, rtol=1e-10,
        dtype=torch.float64, precond="amg", device="cpu")
    assert rj.timings["precond_used"] == rt.timings["precond_used"] == "amg"
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert _rel(rt.u_full, rj.u_full) < 1e-9


def test_amg_falls_back_to_jacobi_on_a_small_system():
    """Under 800 rows nothing coarsens: both packages run Jacobi; the
    port's timings say so."""
    jm, jd = ft.generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    tm, td = pt.generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, precond="amg")
    rt = pt.solve_poisson(tm, td, rtol=1e-10, precond="amg",
                          dtype=torch.float64, device="cpu")
    assert rj.timings["precond_used"] == "jacobi"
    assert rt.timings["precond_requested"] == "amg"
    assert rt.timings["precond_used"] == "jacobi"
    assert rt.stats.iters == int(rj.stats.iters)


@pytest.mark.parametrize("case", ["scrambled", "delaunay"])
def test_amg_on_the_ell_path_is_in_jax_band(case):
    """End to end on an ELL system the port solves in its own row order and
    the JAX package on the CPU in the natural one; aggregation is order
    dependent, so a band is held (the unit tests hold the permuted CSR)."""
    jm, jd = _scrambled(12, seed=1) if case == "scrambled" \
        else _delaunay(12, seed=2)
    rj = j_solve_implicit(jm, 1, jd, POISSON_J, rtol=1e-10, recover=False,
                          precond="amg")
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    rt = solve_implicit(tm, 1, jd, POISSON_T, rtol=1e-10, recover=False,
                        dtype=torch.float64, precond="amg", device="cpu")
    assert "order_s" in rt.timings
    assert rt.timings["precond_used"] == rj.timings["precond_used"] == "amg"
    assert rt.stats.converged
    assert rt.stats.iters <= int(rj.stats.iters) + 3
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-8


def test_device_routing_picks_the_cheapest_form_and_agrees():
    """Each form of a routed block gives the plain ELL product."""
    rng = np.random.default_rng(7)

    def check(cols, vals, n_cols, kind, dtype=torch.float64):
        d = tad.build_device_ell(cols, vals, n_cols, dtype=dtype, device="cpu")
        assert d.kind == kind
        x = torch.as_tensor(rng.standard_normal(n_cols), dtype=dtype)
        ref = spmv_ell(interop.ell_from_numpy(cols, vals, n_cols,
                                              dtype=dtype, device="cpu"), x)
        tad.route_calls.clear()
        y = tad.device_ell_apply(d, x)
        assert sum(tad.route_calls.values()) == 1
        assert _rel(y, ref) < 1e-14
        return d

    # banded square block, a few diagonals, mostly full rows: DIA
    n = 50_000
    offs = np.array([-300, -1, 0, 1, 300])
    cols = np.arange(n)[:, None] + offs[None, :]
    cols = np.where((cols >= 0) & (cols < n), cols, n)
    d = check(cols, rng.standard_normal(cols.shape), n, "dia")
    assert d.dia.offsets == tuple(int(o) for o in offs)
    # scattered square block: ELL
    cols = rng.integers(0, n, (n, 8))
    cols.sort(axis=1)
    check(cols, rng.standard_normal(cols.shape), n, "ell")
    # rectangular skinny transfer (one entry a row): ELL
    check(rng.integers(0, 900, (n, 8)) * (np.arange(8) == 0) +
          900 * (np.arange(8) > 0), rng.standard_normal((n, 8)), 900, "ell")
    # small nearly dense block: dense
    cols = np.tile(np.arange(60), (60, 1))
    check(cols, rng.standard_normal(cols.shape), 60, "dense")
    # sentinels past n_cols and an all-sentinel row
    cols = rng.integers(0, 40, (30, 8))
    cols[5] = 40
    cols[7, 3] = 2 * 30 + 128
    check(cols, rng.standard_normal(cols.shape), 40, "ell")
