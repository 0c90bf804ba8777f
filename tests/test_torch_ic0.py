"""Port parity: IC(0) with truncated-Neumann application (solve/ic0.py), its
host library (csrc/host_native.cpp through host_native.py) and its routed
application (solve/amg_device.py).

The same CSR matrices (assembled by the JAX package from generated meshes,
a renumbered box and a scrambled Delaunay mesh, the last two permuted into
the port's ELL row order as its solve does) go into both packages in
float64 on the CPU.  The host factorization must be IDENTICAL to the JAX
package's (native library, or its Python loop where that is not built);
the staged T / T^T blocks and 1/diag(L) identical; each application within
1e-12 of both JAX forms (`ic0_preconditioner`, `ic0_device_preconditioner`),
also on a JAX-built factor carried over with `interop.ic0_from_numpy`; the
IC(0)-preconditioned lattice solve takes JAX's iteration count with u
within 1e-10.
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
from pfemfort_tpu.elements import elasticity as je
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.solve import amg_device as jad
from pfemfort_tpu.solve import ic0 as jic
from pfemfort_tpu_torch import host_native, interop
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler, solve_implicit
from pfemfort_tpu_torch.elements import elasticity as te
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import amg_device as tad
from pfemfort_tpu_torch.solve import ic0 as tic

torch.set_num_threads(1)

TOL = 1e-12
POISSON_T = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
POISSON_J = lambda c: j_pem(c, "tetra4", source=-6.0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _delaunay(n, seed=0):
    """Delaunay tets of a jittered (n+1)^3 lattice, nodes scrambled; u =
    x^2+y^2+z^2 on the hull."""
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


def _scrambled(n, seed=0):
    mesh, dbc = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return ft.Mesh(mesh.etype, mesh.coords, mesh.conn).renumbered(perm), dbc


def _ordered_csr(mesh, dbc):
    """The port's CSR of an ELL system in its solve's row order (the
    EllOrdering the driver picks), as drivers/common.py builds it."""
    tm = interop.mesh_from_numpy(mesh.etype, mesh.coords, mesh.conn)
    dofmap = build_dofmap(tm, 1, dbc)
    asm = build_reduced_assembler(tm, 1, dofmap, POISSON_T, torch.float64,
                                  "cpu")
    assert asm.pattern.layout == "ell"
    A, _ = asm(torch.as_tensor(to_element_minor(tm.elem_coords())))
    ordering = build_ell_ordering(asm.pattern, tm.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, "cpu")
    indptr, indices, vals, n = tic._csr_from_matrix(A, asm.pattern)
    order = ordering.order.numpy()
    jcsr = jad.permute_csr(indptr, indices, vals, order)
    tcsr = tad.permute_csr(indptr, indices, vals, order)
    for a, b in zip(tcsr, jcsr):
        np.testing.assert_array_equal(a, b)
    return (*tcsr, n)


def _csr(case):
    """(indptr, indices, vals, n) of one SPD system, checked equal between
    the two packages' _csr_from_matrix where both can read it."""
    if case in ("delaunay", "scrambled"):
        return _ordered_csr(*(_delaunay(8) if case == "delaunay"
                              else _scrambled(7)))
    if case == "box":
        mesh, dbc = ft.generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
        ndof, fn = 1, POISSON_J
    else:
        mesh, _ = ft.generate.box_tet(0, 1, 3, 0, 1, 2, 0, 1, 2)
        left = np.nonzero(mesh.coords[:, 0] == 0)[0]
        dbc = np.stack([np.repeat(left, 3), np.tile(np.arange(3), len(left)),
                        np.zeros(3 * len(left))], 1)
        ndof = 3
        fn = lambda c: je.elasticity_stiffness(c, "tetra4",
                                               je.dmat_3d(200.0, 0.3))
    dofmap = j_build_dofmap(mesh, ndof, dbc)
    asm, _ = j_bra(mesh, ndof, dofmap, fn, jnp.float64)
    A, _ = asm(jnp.asarray(to_element_minor(mesh.elem_coords())))
    jcsr = jic._csr_from_matrix(A, getattr(asm, "pattern", None))
    At = interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                A.lattice, dtype=torch.float64, device="cpu")
    tcsr = tic._csr_from_matrix(At)
    for a, b in zip(tcsr, jcsr):
        np.testing.assert_array_equal(a, b)
    return tcsr


CASES = ["box", "elasticity", "scrambled", "delaunay"]


def _lower(indptr, indices, vals, n):
    lower = indices <= np.repeat(np.arange(n), np.diff(indptr))
    lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(np.repeat(np.arange(n), np.diff(indptr))[lower],
                          minlength=n), out=lp[1:])
    return lp, np.ascontiguousarray(indices[lower], np.int32), \
        np.ascontiguousarray(vals[lower], np.float64)


@pytest.mark.parametrize("case", CASES)
def test_host_factor_is_identical_to_jax(case):
    from pfemfort_tpu import native

    lp, li, lv = _lower(*_csr(case))
    lv_t, lv_j = lv.copy(), lv.copy()
    fix_t = host_native.ic0(lp, li, lv_t)
    if native.available():
        fix_j = native.ic0(lp, li, lv_j)
    else:
        fix_j = jic._ic0_python(lp, li.astype(np.int64), lv_j)
    assert fix_t == fix_j == 0
    np.testing.assert_array_equal(lv_t, lv_j)


def test_host_factor_is_exact_on_a_tridiagonal_matrix():
    n = 50
    rng = np.random.default_rng(0)
    main = 4.0 + rng.random(n)
    off = -1.0 + 0.1 * rng.random(n - 1)
    A = np.diag(main) + np.diag(off, -1) + np.diag(off, 1)
    lp = np.concatenate([[0], 1 + 2 * np.arange(n)]).astype(np.int64)
    li = np.concatenate([[0], np.stack([np.arange(n - 1),
                                        np.arange(1, n)], 1).reshape(-1)])
    lv = np.concatenate([[main[0]], np.stack([off, main[1:]],
                                             1).reshape(-1)])
    lv = np.ascontiguousarray(lv)
    assert host_native.ic0(lp, li.astype(np.int32), lv) == 0
    L = np.zeros((n, n))
    for i in range(n):
        for p in range(lp[i], lp[i + 1]):
            L[i, li[p]] = lv[p]
    np.testing.assert_allclose(L @ L.T, A, atol=1e-12)


def test_host_library_refuses_bad_arrays():
    lp = np.array([0, 1, 2], np.int64)
    li = np.array([0, 1], np.int32)
    with pytest.raises(ValueError, match="float64"):
        host_native.ic0(lp, li, np.ones(2, np.float32))
    with pytest.raises(ValueError, match="n \\+ 1"):
        host_native.samg_aggregate(lp, li, 5)


@pytest.mark.parametrize("case", CASES)
def test_ic0_arrays_and_applies_match_jax(case):
    indptr, indices, vals, n = _csr(case)
    ja = jic.build_ic0_from_csr(indptr, indices, vals, n, dtype=jnp.float64)
    ta = tic.build_ic0_from_csr(indptr, indices, vals, n,
                                dtype=torch.float64, device="cpu")
    for (cj, vj), blk in (((ja.t_cols, ja.t_vals), ta.t),
                          ((ja.tt_cols, ja.tt_vals), ta.tt)):
        np.testing.assert_array_equal(blk.cols.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(blk.vals.numpy(), np.asarray(vj))
        assert blk.n_cols == n
    np.testing.assert_array_equal(ta.dinv.numpy(), np.asarray(ja.dinv))

    r = np.random.default_rng(5).standard_normal(n)
    z_j = np.asarray(jic.ic0_preconditioner(ja)(jnp.asarray(r)))
    z_jd = np.asarray(jad.ic0_device_preconditioner(
        jad.build_ic0_device(ja, dtype=jnp.float64))(jnp.asarray(r)))
    assert _rel(z_jd, z_j) < TOL
    carried = interop.ic0_from_numpy(ja, dtype=torch.float64, device="cpu")
    for z in (tic.ic0_preconditioner(ta)(torch.as_tensor(r)),
              tad.ic0_device_preconditioner(tad.build_ic0_device(
                  ta, dtype=torch.float64, device="cpu"))(torch.as_tensor(r)),
              tic.ic0_preconditioner(carried)(torch.as_tensor(r))):
        assert _rel(z, z_j) < TOL and _rel(z, z_jd) < TOL


@pytest.mark.parametrize("n", [6, 8])
def test_ic0_solve_matches_jax_on_the_lattice(n):
    jm, jd = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    tm, td = pt.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, precond="ic0")
    rt = pt.solve_poisson(tm, td, rtol=1e-10, precond="ic0",
                          dtype=torch.float64, device="cpu")
    assert rt.stats.converged and rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    assert rt.timings["precond_used"] == "ic0" and "ic0_setup_s" in \
        rt.timings


def test_ic0_elasticity_matches_jax():
    """solve_implicit(ndof=3, precond='ic0') on a clamped, loaded box.  The
    pattern assembly sums each entry's contributions in another order than
    JAX's segment_sum; at rtol 1e-10 that moves this count by one."""
    jm, _ = ft.generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    base = np.nonzero(np.isclose(jm.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    fbc = np.array([[int(np.argmax(jm.coords.sum(axis=1))), 0, 1.0]])
    rj = j_solve_implicit(jm, 3, dbc, lambda c: je.elasticity_stiffness(
        c, "tetra4", je.dmat_3d(210.0, 0.3)), force_bc=fbc, rtol=1e-10,
        precond="ic0")
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn, jm.structure)
    rt = solve_implicit(tm, 3, dbc, lambda c: te.elasticity_stiffness(
        c, "tetra4", te.dmat_3d(210.0, 0.3)), force_bc=fbc, rtol=1e-10,
        dtype=torch.float64, precond="ic0", device="cpu")
    assert rt.stats.converged and abs(rt.stats.iters - int(rj.stats.iters)) \
        <= 1
    assert _rel(rt.u_full, rj.u_full) < 1e-9


def test_ic0_on_the_ell_path_is_in_jax_band():
    """The renumbered box on the ELL path: the port factors the CSR in its
    own row order, the JAX package on the CPU in the scrambled natural one.
    IC(0) is order dependent and the port's order (lex, which restores the
    lattice) is the better one, so the port may take fewer iterations,
    never more than two above JAX (the unit tests above hold the same
    permuted CSR exactly)."""
    jm, jd = _scrambled(7, seed=1)
    rj = j_solve_implicit(jm, 1, jd, POISSON_J, rtol=1e-10, recover=False,
                          precond="ic0")
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    rt = solve_implicit(tm, 1, jd, POISSON_T, rtol=1e-10, recover=False,
                        dtype=torch.float64, precond="ic0", device="cpu")
    assert rt.timings["ordering"] == "lex"
    assert rt.timings["precond_used"] == "ic0"
    assert rt.stats.converged
    assert rt.stats.iters <= int(rj.stats.iters) + 2
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-8
