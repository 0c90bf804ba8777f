"""The IC(0) host set-up's one-pass forms against the JAX package's forms,
bit for bit, and the reference's own solver on the reduced elasticity
system (CPU, float64).

The DIA matrix's CSR is held against the JAX package's
`solve/ic0.py:_csr_from_matrix` (a `np.lexsort` over every stored entry),
and T, T^T and 1/diag(L) against its `build_ic0_from_csr` (its host
library's factor, T split off with numpy and transposed by a second
`np.lexsort`), in float64 and float32.  The routing of T and T^T is the
port's own: it is held against the port's former form, kept here (a
`np.unique` census and a full hybrid plan for each split).  On DIA
matrices of 2D and 3D meshes with ndof 1, 2 and 3, a DIA matrix with gaps
between its offsets given out of order, and the ELL path's matrix, the
new forms must hand on the same indptr, indices, values, T, T^T,
1/diag(L) and routed blocks, byte for byte.

The solver: `solve_elasticity(precond='ic0')` on a slender beam clamped at
one end (24 x 4 x 4 cells over [0, 6] x [0, 1] x [0, 1]), held against the
benchmark's plain reference (benchmark/reference/fem.py: element by
element, nothing of the port).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfemfort_tpu_torch as pt
from pfemfort_tpu.solve import ic0 as jic
from pfemfort_tpu.sparse.dia import DIAMatrix as JDIAMatrix
from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.drivers import common
from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
    dmat_plane_stress, elasticity_stiffness
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve import amg_device as tad
from pfemfort_tpu_torch.solve import ic0 as tic
from pfemfort_tpu_torch.sparse.dia import DIAMatrix
from pfemfort_tpu_torch.sparse.hybrid import build_hybrid_plan, \
    hybrid_from_plan, plan_bytes
from pfemfort_tpu_torch.sparse.sliced import slice_ell, sliced_slots

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmark.reference import fem  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
E_MOD, NU = 240.565, 0.3


# ---- the routing's former form -----------------------------------------------
def _old_dia_form(cols, vals, n):
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], cols.shape)
    valid = cols < n
    offs = cols[valid].astype(np.int64) - rows[valid]
    uniq = np.unique(offs)
    if len(uniq) > tad.DIA_MAX_OFFSETS:
        return None
    flat = np.searchsorted(uniq, offs) * n + rows[valid]
    dvals = np.bincount(flat, weights=vals[valid], minlength=len(uniq) * n)
    return tuple(int(o) for o in uniq), dvals.reshape(len(uniq), n)


def _old_device_ell(cols, vals, n_cols, dtype):
    """The old build_device_ell's choice and laid-out arrays."""
    vals = np.asarray(vals, dtype=np.float64)
    n = cols.shape[0]
    size = torch.empty((), dtype=dtype).element_size()
    cand = [(sliced_slots(cols, n_cols) * (size + 4), "ell", None)]
    if n == n_cols and n > 0:
        dia = _old_dia_form(cols, vals, n)
        if dia is not None:
            cand.append((len(dia[0]) * n * size, "dia", dia))
        for thr, max_d in tad.HYBRID_SPLITS:
            plan = build_hybrid_plan(cols, n, fill_threshold=thr,
                                     max_d=max_d)
            cand.append((plan_bytes(plan, size), "hybrid", plan))
    if n * n_cols <= tad.DENSE_MAX_ENTRIES:
        cand.append((n * n_cols * size, "dense", None))
    _, kind, payload = min(cand, key=lambda c: c[0])
    as_t = lambda a: torch.as_tensor(a, dtype=dtype)
    if kind == "hybrid":
        return kind, _hybrid_arrays(hybrid_from_plan(payload, vals, dtype,
                                                     "cpu"))
    if kind == "dia":
        return kind, [np.array(payload[0]), as_t(payload[1]).numpy()]
    if kind == "dense":
        dense = np.zeros((n, n_cols), dtype=np.float64)
        ok = cols < n_cols
        rr = np.broadcast_to(np.arange(n)[:, None], cols.shape)
        np.add.at(dense, (rr[ok], cols[ok]), vals[ok])
        return kind, [as_t(dense).numpy()]
    S = slice_ell(torch.as_tensor(cols), n_cols).pack(as_t(vals))
    return kind, _sliced_arrays(S)


def _sliced_arrays(S):
    return [S.cols.numpy(), S.vals.numpy(), S.slice_ptr.numpy(),
            np.array([S.n_rows, S.n_cols, S.max_width])]


def _hybrid_arrays(H):
    out = []
    if H.dia is not None:
        out += [np.array(H.dia.offsets), H.dia.vals.numpy()]
    if H.rem is not None:
        out += _sliced_arrays(H.rem)
    return out


def _new_device_ell(cols, vals, n_cols, dtype):
    d = tad.build_device_ell(cols, vals, n_cols, dtype=dtype, device="cpu")
    if d.kind == "hybrid":
        return d.kind, _hybrid_arrays(d.hybrid)
    if d.kind == "dia":
        return d.kind, [np.array(d.dia.offsets), d.dia.vals.numpy()]
    if d.kind == "dense":
        return d.kind, [d.dense.numpy()]
    return d.kind, _sliced_arrays(d.ell)


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---- the matrices ------------------------------------------------------------
def _clamped(mesh, ndof):
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    return np.stack([np.repeat(nodes, ndof),
                     np.tile(np.arange(ndof), len(nodes)),
                     np.zeros(ndof * len(nodes))], 1)


def _assembled(mesh, ndof, dbc, fn, recover=True):
    """(A, pattern, ordering) of the reduced system, as solve_implicit
    builds them."""
    if not recover:
        mesh = pt.Mesh(mesh.etype, mesh.coords, mesh.conn)
    dofmap, asm, coords, _ = common._reduced_setup(
        mesh, ndof, dbc, fn, None, F64, torch.device("cpu"), {})
    A, _ = asm(coords)
    pattern = getattr(asm, "pattern", None)
    ordering = None
    if pattern is not None and pattern.layout == "ell":
        ordering = common.build_ell_ordering(
            pattern, mesh.coords[dofmap.assy_for_soln // ndof],
            dofmap.assy_for_soln % ndof, "cpu")
    return A, pattern, ordering


def _gapped_dia(n=70_000, seed=3):
    """An SPD DIA matrix with gaps between its offsets, given out of order:
    a diagonally dominant symmetric band with some zero stored entries;
    rows enough for the host library's passes to run in threads."""
    rng = np.random.default_rng(seed)
    half = (1, 7, 40, 41, 300)
    offsets = (0, 300, -1, 41, -7, 1, -300, 7, -41, 40, -40)
    vals = np.zeros((len(offsets), n))
    band = {o: rng.uniform(-1.0, 1.0, n) * (rng.random(n) > 0.1)
            for o in half}
    for d, o in enumerate(offsets):
        if o == 0:
            vals[d] = 2.0 * len(half) + rng.random(n)
        elif o > 0:
            vals[d, :n - o] = band[o][:n - o]
        else:   # A[r, r + o] = A[r + o, r], stored in row r
            vals[d, -o:] = band[-o][:n + o]
    return DIAMatrix(vals=torch.as_tensor(vals), offsets=offsets, n_rows=n)


def _poisson3d():
    mesh, dbc = pt.generate.box_tet(0, 1, 7, 0, 1, 6, 0, 1, 5)
    return _assembled(mesh, 1, dbc, lambda c: poisson_element_matrices(
        c, "tetra4", source=-6.0))


def _poisson2d():
    mesh = pt.generate.rect_tria(0, 2, 20, 0, 1, 11)
    return _assembled(mesh, 1, _clamped(mesh, 1),
                      lambda c: poisson_element_matrices(
        c, "tria3", source=0.0))


def _elasticity2d():
    mesh = pt.generate.rect_tria(0, 2, 16, 0, 1, 8)
    return _assembled(mesh, 2, _clamped(mesh, 2),
                      lambda c: elasticity_stiffness(
                          c, "tria3", dmat_plane_stress(E_MOD, NU)))


def _elasticity3d():
    mesh, _ = pt.generate.box_tet(0, 6, 12, 0, 1, 3, 0, 1, 3)
    return _assembled(mesh, 3, _clamped(mesh, 3),
                      lambda c: elasticity_stiffness(c, "tetra4",
                                                     dmat_3d(E_MOD, NU)))


def _ell_path():
    mesh, dbc = pt.generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    perm = np.random.default_rng(1).permutation(mesh.n_node)
    inv = np.argsort(perm)
    m = pt.Mesh(mesh.etype, mesh.coords[perm], inv[mesh.conn])
    d = dbc.copy()
    d[:, 0] = inv[dbc[:, 0].astype(np.int64)]
    A, pattern, ordering = _assembled(
        m, 1, d, lambda c: poisson_element_matrices(c, "tetra4",
                                                    source=-6.0),
        recover=False)
    assert pattern.layout == "ell" and ordering is not None
    return A, pattern, ordering


SYSTEMS = {"poisson3d": _poisson3d, "poisson2d": _poisson2d,
           "elasticity2d": _elasticity2d, "elasticity3d": _elasticity3d,
           "gapped": lambda: (_gapped_dia(), None, None),
           "ell_path": _ell_path}


# ---- bit for bit -------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_the_csr_factor_and_routes_are_the_old_bytes(case):
    A, pattern, ordering = SYSTEMS[case]()
    if isinstance(A, DIAMatrix):
        new = tic._csr_from_matrix(A)
        ref = jic._csr_from_matrix(JDIAMatrix(
            vals=jnp.asarray(A.vals.numpy()), offsets=tuple(A.offsets),
            n_rows=A.n_rows))
        for a, b in zip(new, ref):
            _same_bytes(a, b)
    csr = common._solve_row_csr(A, pattern, ordering)
    for dtype, jdtype in ((F64, jnp.float64), (torch.float32, jnp.float32)):
        ref = jic.build_ic0_from_csr(*csr, dtype=jdtype)
        t = {}
        arrs = tic.build_ic0_from_csr(*csr, dtype=dtype, device="cpu",
                                      timings=t)
        for g, r in ((arrs.t.cols, ref.t_cols), (arrs.t.vals, ref.t_vals),
                     (arrs.tt.cols, ref.tt_cols),
                     (arrs.tt.vals, ref.tt_vals), (arrs.dinv, ref.dinv)):
            _same_bytes(g.numpy(), np.asarray(r))
        assert t["ic0.t_nnz"] == int((np.asarray(ref.t_cols) < csr[3]).sum())
        for blk in (arrs.t, arrs.tt):
            cols = blk.cols.numpy()
            vals = blk.vals.to(F64).numpy()
            k_new, a_new = _new_device_ell(cols, vals, blk.n_cols, dtype)
            k_old, a_old = _old_device_ell(cols, vals, blk.n_cols, dtype)
            assert k_new == k_old
            for a, b in zip(a_new, a_old):
                _same_bytes(a, b)


def _random_block(n, k, offsets, sparse_offsets, seed):
    """An (n, k) ELL block: every row on `offsets`, a few rows also on
    each of `sparse_offsets` (a remainder the hybrid splits leave)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n)
    cols = np.full((n, k), n, dtype=np.int32)
    fill = np.zeros(n, dtype=np.int64)
    for o in offsets:
        c = rows + o
        ok = (c >= 0) & (c < n)
        cols[rows[ok], fill[ok]] = c[ok]
        fill[ok] += 1
    for o in sparse_offsets:
        pick = rng.choice(n, size=max(n // 200, 1), replace=False)
        c = pick + o
        ok = (c >= 0) & (c < n) & (fill[pick] < k)
        cols[pick[ok], fill[pick[ok]]] = c[ok]
        fill[pick[ok]] += 1
    vals = np.where(cols < n, rng.standard_normal(cols.shape), 0.0)
    return cols, vals


@pytest.mark.parametrize("kind,n,k,offsets,sparse", [
    ("hybrid", 6000, 16, (-2, -1, 0, 1, 2), tuple(range(50, 3000, 97))),
    ("hybrid", 6000, 144, tuple(range(-70, 70)), ()),
    ("ell", 6000, 16, (), tuple(range(-2900, 2900, 37))),
    ("dia", 70_000, 8, (-50, -3, 0, 3, 50), ()),
    ("dense", 40, 40, tuple(range(-39, 40)), ())])
def test_every_route_is_the_old_one(kind, n, k, offsets, sparse):
    """Blocks whose cheapest form is each of the four (the hybrid with a
    remainder, and with none past the DIA form's 128 offsets): the
    census-priced choice and its arrays are the old ones."""
    cols, vals = _random_block(n, k, offsets, sparse, seed=n + k)
    for dtype in (F64, torch.float32):
        k_new, a_new = _new_device_ell(cols, vals, n, dtype)
        k_old, a_old = _old_device_ell(cols, vals, n, dtype)
        assert k_new == k_old == kind
        for a, b in zip(a_new, a_old):
            _same_bytes(a, b)


def test_the_host_passes_refuse_bad_arrays():
    ip = np.array([0, 1, 2], np.int64)
    with pytest.raises(ValueError, match="CSR"):
        host_native.csr_lower(ip, np.array([0, 2], np.int32),
                              np.ones(2), 2)
    with pytest.raises(ValueError, match="CSR"):
        host_native.ic0_ell(np.array([0, 2, 1], np.int64),
                            np.array([0, 1], np.int32), np.ones(2),
                            np.ones(2), 8)
    with pytest.raises(ValueError, match="offset"):
        host_native.dia_to_csr(np.ones((2, 5)), (0,))
    with pytest.raises(ValueError, match="off the given offsets"):
        host_native.ell_to_dia(np.array([[1, 2], [0, 2]], np.int32),
                               np.ones((2, 2)), (0,))


# ---- the reference's solver on the reduced elasticity system ----------------
def _beam(seed=2 ** 31 + 7):
    mesh, _ = pt.generate.box_tet(0, 6, 24, 0, 1, 4, 0, 1, 4)
    scale = np.random.default_rng(seed).uniform(0.5, 2.0)
    return mesh, _clamped(mesh, 3), (0.0, 0.1 * scale, 0.0)


def _reference_system(mesh, bforce):
    """Dense K and F of the full system, and the clamped dofs, from the
    plain reference."""
    coords = torch.as_tensor(mesh.coords, dtype=F64)
    conn = torch.as_tensor(mesh.conn)
    p = fem.make_problem("elasticity", coords, conn, E=E_MOD, nu=NU)
    Ke = fem._element_matrices(p, slice(None))
    dofs = fem._dofs(p, slice(None))
    K = torch.zeros(p.n_full, p.n_full, dtype=F64)
    K.index_put_((dofs[:, :, None].expand(-1, -1, 12),
                  dofs[:, None, :].expand(-1, 12, -1)), Ke, accumulate=True)
    F = fem.nodal_load(p, torch.tensor(bforce, dtype=F64))
    return p, K, F


def test_ic0_solves_the_beam_as_the_reference_does():
    """One IC(0) block, rtol 1e-8 as the reference's drivers: the true
    residual of the plain reference's system within 1e-8; u within kappa
    times that residual of the reference's exact solution (the bound
    |e| / |u| <= kappa(K) |r| / |b| of any answer to a system of condition
    number kappa, kappa from the reduced system's extreme eigenvalues);
    fewer iterations than Jacobi's on the same system."""
    mesh, dbc, bforce = _beam()
    res = {pc: pt.solve_elasticity(mesh, dbc, E_MOD, NU, bforce=bforce,
                                   rtol=1e-8, dtype=F64, precond=pc,
                                   device="cpu")
           for pc in ("ic0", "jacobi")}
    r = res["ic0"]
    assert r.stats.converged and r.timings["precond_used"] == "ic0"
    assert "ic0_setup_s" in r.timings
    assert r.stats.iters < res["jacobi"].stats.iters

    p, K, F = _reference_system(mesh, bforce)
    bc = torch.as_tensor(dbc[:, 0].astype(np.int64) * 3
                         + dbc[:, 1].astype(np.int64))
    free = torch.ones(p.n_full, dtype=torch.bool)
    free[bc] = False
    Kf = K[free][:, free]
    u_exact = torch.linalg.solve(Kf, F[free])
    eig = torch.linalg.eigvalsh(Kf)
    kappa = float(eig[-1] / eig[0])
    for pc, rr in res.items():
        u = torch.as_tensor(rr.u_full)
        norms = fem.residual_norms(p, F, u, bc, torch.zeros(len(bc),
                                                            dtype=F64))
        relres = norms["r_free"] / norms["b_reduced"]
        assert relres <= 1e-8 and norms["bc_misfit"] == 0.0, pc
        err = float(torch.linalg.vector_norm(u[free] - u_exact)
                    / torch.linalg.vector_norm(u_exact))
        assert err <= kappa * relres, (pc, err, kappa, relres)


@pytest.mark.parametrize("drift,converged", [(1.0, True), (3.0, False)])
def test_an_answer_worse_than_the_zero_start_is_not_converged(
        monkeypatch, drift, converged):
    """The Krylov loop meets rtol by its recurrence and hands back its
    answer times `drift`.  At 3 the answer's residual, about -2 b, is
    larger than b, as float32 CG of the 4.5M-element beam to rtol 1e-8
    left it (16 to 23 times b on the card, with IC(0) and with Jacobi):
    the solve reports it unconverged.  The sound answer stays converged."""
    orig = common._SOLVERS["cg"]

    def drifted(operator, b, **kw):
        u, stats = orig(operator, b, **kw)
        return u * drift, stats

    monkeypatch.setitem(common._SOLVERS, "cg", drifted)
    mesh, dbc, bforce = _beam()
    for pc in ("ic0", "jacobi"):
        r = pt.solve_elasticity(mesh, dbc, E_MOD, NU, bforce=bforce,
                                rtol=1e-8, dtype=F64, precond=pc,
                                device="cpu")
        assert r.stats.relres <= 1e-8, pc
        assert r.stats.converged is converged, pc


@pytest.mark.parametrize("precond", ["ic0", "amg", "cheby"])
def test_a_preconditioner_the_full_system_lacks_raises(precond):
    mesh, dbc, bforce = _beam()
    with pytest.raises(ValueError, match="'jacobi', 'mg'"):
        pt.solve_elasticity(mesh, dbc, E_MOD, NU, bforce=bforce,
                            bc_mode="full", precond=precond, dtype=F64,
                            device="cpu")
    with pytest.raises(ValueError, match="refine"):
        pt.solve_elasticity(mesh, dbc, E_MOD, NU, bforce=bforce,
                            refine=True, precond=precond, device="cpu")
