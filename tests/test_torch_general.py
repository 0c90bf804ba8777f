"""Port parity end to end on meshes off the generator lattice.

`solve_implicit` and `solve_poisson` of both packages, in float64 on the
CPU, on: a randomly renumbered box_tet (the ELL path with recover=False,
the recovered DIA path with recover=True), a scrambled Delaunay mesh (ELL
through solve_poisson) and a mesh written with `write_dat` and read back
with `read_problem`.  Each must take the JAX package's iteration count and
give its u_full within 1e-9.

Iteration counts: the port solves an ELL system in a bandwidth-reducing
row order and the JAX package on the CPU in the mesh's own order.  The
same CG in another row order sums its dot products in another order, so
the counts may differ by one where the last residual lands within
round-off of the tolerance; they are allowed to differ by at most 1.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu.drivers.common import solve_implicit as j_solve_implicit
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pe
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.drivers.common import solve_implicit
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
U_TOL = 1e-9
RTOL = 1e-10


def scrambled_delaunay(n, seed=0):
    """Delaunay tets of a jittered (n+1)^3 lattice of the unit cube, nodes
    randomly renumbered; Dirichlet u = x^2+y^2+z^2 on the hull.  Self-
    contained (numpy and scipy only), so that its source also runs in a
    process without JAX."""
    import numpy as np
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
    dbc = np.stack([hull, np.zeros(len(hull)), (pts[hull] ** 2).sum(1)], 1)
    perm = rng.permutation(len(pts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(pts))
    dbc[:, 0] = perm[hull]
    return pts[inv], perm[conn].astype(np.int32), dbc


def _permuted_box(n):
    """box_tet n, nodes randomly renumbered (no structure left)."""
    mesh, dbc = ft.generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(0).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh.coords, mesh.conn, dbc


def _both_meshes(coords, conn):
    return (ft.Mesh("tetra4", coords, conn),
            interop.mesh_from_numpy("tetra4", coords, conn))


def _assert_same(rt, rj):
    assert rt.stats.converged and bool(rj.stats.converged)
    assert abs(rt.stats.iters - int(rj.stats.iters)) <= 1
    assert np.abs(rt.u_full - rj.u_full).max() <= U_TOL


@pytest.mark.parametrize("recover", [False, True])
def test_permuted_box_solve_implicit_matches_jax(recover):
    coords, conn, dbc = _permuted_box(6)
    jm, tm = _both_meshes(coords, conn)
    rj = j_solve_implicit(jm, 1, dbc, lambda c: j_pe(c, "tetra4", source=-6.0),
                          rtol=RTOL, recover=recover)
    rt = solve_implicit(
        tm, 1, dbc, lambda c: poisson_element_matrices(c, "tetra4",
                                                       source=-6.0),
        dtype=torch.float64, rtol=RTOL, recover=recover, device="cpu")
    _assert_same(rt, rj)
    assert rt.timings.get("structure_recovered", False) == recover
    assert rj.timings.get("structure_recovered", False) == recover
    assert ("order_s" in rt.timings) == (not recover)   # ELL path
    assert rt.u_reduced.dtype == torch.float64
    u_exact = (tm.coords ** 2).sum(axis=1)
    assert np.abs(rt.u_full - u_exact).max() < 1e-8


def test_scrambled_delaunay_solve_poisson_matches_jax():
    coords, conn, dbc = scrambled_delaunay(8)
    jm, tm = _both_meshes(coords, conn)
    rj = ft.solve_poisson(jm, dbc, rtol=RTOL)
    rt = pt.solve_poisson(tm, dbc, dtype=torch.float64, rtol=RTOL,
                          device="cpu")
    _assert_same(rt, rj)
    assert "order_s" in rt.timings
    assert "structure_recovered" not in rt.timings
    assert not rj.timings.get("structure_recovered", False)


def test_dat_round_trip_solves_like_jax(tmp_path):
    coords, conn, dbc = _permuted_box(5)
    prefix = str(tmp_path / "box")
    pt.mesh_io.write_dat(prefix, interop.mesh_from_numpy("tetra4", coords,
                                                         conn), dbc)
    tm, td, tf = pt.mesh_io.read_problem(prefix)
    jm, jd, jf = ft.mesh_io.read_problem(prefix)
    assert tf is None and jf is None and tm.etype == jm.etype == "tetra4"
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.conn, jm.conn)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tm.coords, coords, rtol=0, atol=1e-8)
    rj = ft.solve_poisson(jm, jd, rtol=RTOL)
    rt = pt.solve_poisson(tm, td, dtype=torch.float64, rtol=RTOL, device="cpu")
    _assert_same(rt, rj)


def test_ell_solve_leaves_jax_out_of_a_fresh_process():
    code = inspect.getsource(scrambled_delaunay) + (
        "import sys, torch, pfemfort_tpu_torch as pt\n"
        "coords, conn, dbc = scrambled_delaunay(8)\n"
        "res = pt.solve_poisson(pt.Mesh('tetra4', coords, conn), dbc, "
        "dtype=torch.float64, device='cpu')\n"
        "assert res.stats.converged and 'order_s' in res.timings\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'pfemfort_tpu.')) or m == 'pfemfort_tpu')\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip() == "[]"
