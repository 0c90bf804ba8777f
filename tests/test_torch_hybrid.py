"""Port parity: the hybrid DIA + ELL split (sparse/hybrid.py) against the
JAX package's build_hybrid_plan / apply_hybrid_reference, its driver path
(float32 ELL systems) and its place among the routed preconditioner blocks
(solve/amg_device.py).

The plans must agree exactly (offsets, the per-diagonal sources, nnz of
both parts) for the same row order and threshold; products within 1e-12
relative in float64 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.assembly.assemble import assemble_matrix as j_assemble
from pfemfort_tpu.assembly.pattern import build_pattern as j_build_pattern
from pfemfort_tpu.dofs.dofmap import build_dofmap
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices as j_pem
from pfemfort_tpu.mesh import generate
from pfemfort_tpu.mesh.core import Mesh as JMesh
from pfemfort_tpu.sparse import hybrid as jhyb
from pfemfort_tpu_torch import interop
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    solve_implicit
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import amg_device
from pfemfort_tpu_torch.solve.cg import cg_solve, jacobi_preconditioner
from pfemfort_tpu_torch.sparse import hybrid as thyb
from pfemfort_tpu_torch.sparse.ops import operator_and_diag
from pfemfort_tpu_torch.sparse.ordering import coord_lex_order, rcm_order
from test_torch_general import scrambled_delaunay

torch.set_num_threads(1)
REL = 1e-12


def _system(kind):
    """(pattern, (N, K) float64 values, row coordinates) of an ELL system."""
    if kind == "scrambled_lattice":
        mesh, dbc = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
        perm = np.random.default_rng(0).permutation(mesh.n_node)
        mesh = mesh.renumbered(perm.astype(np.int64))
        dbc = dbc.copy()
        dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    else:
        coords, conn, dbc = scrambled_delaunay(7, seed=3)
        mesh = JMesh("tetra4", coords, conn)
    dm = build_dofmap(mesh, 1, dbc)
    pattern = j_build_pattern(dm.elem_dof, dm.total_dof, layout="ell")
    Ke, _ = j_pem(jnp.asarray(to_element_minor(mesh.elem_coords())),
                  "tetra4", source=-6.0)
    A = j_assemble(Ke, pattern)
    return pattern, np.array(A.vals), mesh.coords[dm.assy_for_soln]


def _order(name, pattern, rows_xyz):
    if name == "lex":
        return coord_lex_order(rows_xyz)
    if name == "rcm":
        return rcm_order(pattern.indptr, pattern.indices, pattern.n_rows)
    return None


def _same_plan(tp, jp):
    assert tp.offsets == jp.offsets
    assert (tp.nnz_dia, tp.nnz_rem) == (jp.nnz_dia, jp.nnz_rem)
    np.testing.assert_array_equal(tp.dia_src, jp.dia_src)
    assert (tp.rem_cols is None) == (jp.sg is None)


def _y(plan, vals, x):
    return thyb.apply_hybrid_reference(plan, vals, x)


@pytest.mark.parametrize("kind,order", [
    ("scrambled_lattice", "lex"), ("scrambled_lattice", "rcm"),
    ("delaunay", "lex"), ("delaunay", "rcm"), ("delaunay", None)])
def test_plan_and_product_match_jax(kind, order):
    pattern, vals, rows_xyz = _system(kind)
    o = _order(order, pattern, rows_xyz)
    jp = jhyb.build_hybrid_plan(pattern.ell_cols, pattern.n_rows, order=o)
    tp = thyb.build_hybrid_plan(pattern.ell_cols, pattern.n_rows, order=o)
    _same_plan(tp, jp)
    assert tp.nnz_dia + tp.nnz_rem == pattern.nnz
    if (kind, order) == ("scrambled_lattice", "lex"):
        # the lex order restores the lattice: 15 diagonals, no remainder
        assert (tp.D, tp.nnz_rem, tp.rem_cols) == (15, 0, None)
    x = np.random.default_rng(4).normal(size=pattern.n_rows)
    y_j = jhyb.apply_hybrid_reference(jp, vals, x)
    y_t = _y(tp, vals, x)
    scale = np.abs(y_j).max()
    assert np.abs(y_t - y_j).max() <= REL * scale
    # the torch operator on both blocks (the kernels' plain versions here)
    layout = thyb.hybrid_layout(tp, "cpu")
    H = layout.pack(torch.as_tensor(vals))
    y_op = thyb.apply_hybrid(H, torch.as_tensor(x)).numpy()
    assert np.abs(y_op - y_j).max() <= REL * scale
    assert torch.equal(thyb.hybrid_from_plan(tp, vals, torch.float64,
                                             "cpu").dia.vals, H.dia.vals)


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_plan_matches_jax_on_random_ell(threshold):
    """The JAX package's own split cases: a low-fill band mix with far
    couplings at threshold 0.3 (both parts non-empty) and threshold 0,
    which takes the max_d cap path."""
    rng = np.random.default_rng(7)
    n, K = 400, 9
    cols = np.full((n, K), n, dtype=np.int64)
    vals = np.zeros((n, K))
    dense = np.zeros((n, n))
    for i in range(n):
        cands = [i] + [c for c in (i - 1, i + 1)
                       if 0 <= c < n and rng.uniform() < 0.6]
        cands = sorted(set(cands + list(rng.choice(n, 3, replace=False))))
        for k, c in enumerate(cands[:K]):
            cols[i, k], vals[i, k] = c, rng.normal()
            dense[i, c] += vals[i, k]
    jp = jhyb.build_hybrid_plan(cols, n, fill_threshold=threshold)
    tp = thyb.build_hybrid_plan(cols, n, fill_threshold=threshold)
    _same_plan(tp, jp)
    assert tp.D >= 1 and tp.rem_cols is not None
    if threshold == 0.0:
        assert tp.D == 48                   # the max_d cap
    x = rng.normal(size=n)
    np.testing.assert_allclose(_y(tp, vals, x), dense @ x, rtol=0,
                               atol=REL * np.abs(dense @ x).max())
    np.testing.assert_allclose(_y(tp, vals, x),
                               jhyb.apply_hybrid_reference(jp, vals, x),
                               rtol=0, atol=REL * np.abs(dense @ x).max())


def _permuted_box(n, seed=0):
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return interop.mesh_from_numpy("tetra4", mesh.coords, mesh.conn), dbc


def _fn(c):
    return poisson_element_matrices(c, "tetra4", source=-6.0)


@pytest.mark.parametrize("kind", ["renumbered_box", "delaunay"])
def test_float32_ell_solve_runs_the_hybrid(kind):
    """A float32 ELL solve goes through the hybrid (timings report the
    split); its count is within 1 of the same system solved through the
    ELL operator alone, and float64 stays on the ELL operator."""
    if kind == "renumbered_box":
        tm, dbc = _permuted_box(8)
    else:
        coords, conn, dbc = scrambled_delaunay(7, seed=1)
        tm = interop.mesh_from_numpy("tetra4", coords, conn)
    r32 = solve_implicit(tm, 1, dbc, _fn, dtype=torch.float32, rtol=1e-5,
                         recover=False, device="cpu")
    assert r32.stats.converged and "hybrid_diagonals" in r32.timings
    if kind == "renumbered_box":
        assert r32.timings["hybrid_diagonals"] == 15
        assert r32.timings["hybrid_nnz_rem"] == 0
    else:
        assert r32.timings["hybrid_nnz_rem"] > 0
    r64 = solve_implicit(tm, 1, dbc, _fn, dtype=torch.float64, rtol=1e-5,
                         recover=False, device="cpu")
    assert "hybrid_diagonals" not in r64.timings
    assert np.abs(r32.u_full - r64.u_full).max() < 1e-4

    # the pure-ELL solve of the same float32 system in the same row order
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap as t_dofmap
    from pfemfort_tpu_torch.drivers.common import build_reduced_assembler
    from pfemfort_tpu_torch.elements.geometry import to_element_minor as tem

    dm = t_dofmap(tm, 1, dbc)
    asm = build_reduced_assembler(tm, 1, dm, _fn, torch.float32, "cpu")
    A0, b = asm(torch.as_tensor(tem(tm.elem_coords()), dtype=torch.float32))
    ordering = build_ell_ordering(asm.pattern, tm.coords[dm.assy_for_soln],
                                  dm.assy_for_soln % 1, "cpu")
    A, bo = ordering.system(A0, b)
    op, diag = operator_and_diag(A)
    _, st = cg_solve(op, bo, precond=jacobi_preconditioner(diag), rtol=1e-5,
                     maxiter=10_000)
    assert abs(r32.stats.iters - st.iters) <= 1


def test_routed_block_takes_the_hybrid_when_it_reads_least():
    """Three full diagonals plus far random couplings: the DIA form has
    too many offsets, ELL reads more bytes than the split; the block is
    routed to the hybrid, and its product is the dense one."""
    rng = np.random.default_rng(2)
    n = 3000
    far = rng.integers(0, n, (n, 2))
    cols = np.concatenate([np.clip(np.arange(n)[:, None] + [-1, 0, 1],
                                   -1, n), far], 1)
    cols = np.sort(np.where((cols < 0) | (cols >= n), n, cols), axis=1)
    cols[:, 1:][cols[:, 1:] == cols[:, :-1]] = n    # one slot per column
    vals = np.where(cols < n, rng.normal(size=cols.shape), 0.0)
    dense = np.zeros((n, n))
    ok = cols < n
    np.add.at(dense, (np.broadcast_to(np.arange(n)[:, None], cols.shape)[ok],
                      cols[ok]), vals[ok])
    amg_device.route_calls.clear()
    d = amg_device.build_device_ell(cols, vals, n, dtype=torch.float64,
                                    device="cpu")
    assert d.kind == "hybrid" and d.hybrid.rem is not None
    x = rng.normal(size=n)
    y = amg_device.device_ell_apply(d, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, dense @ x, rtol=0,
                               atol=REL * np.abs(dense @ x).max())
    assert amg_device.route_calls["hybrid"] == 1
