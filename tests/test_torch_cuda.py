"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device.  This file imports no
JAX, so it runs where JAX is not installed:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch import generate, interop, solve_poisson
from pfemfort_tpu_torch.sparse import dia_spmv_cuda, ell_spmv_cuda
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia
from pfemfort_tpu_torch.sparse.formats import ELLMatrix
from pfemfort_tpu_torch.sparse.ops import dia_operator
from pfemfort_tpu_torch.sparse.sliced import SLICE, SlicedELL, \
    ell_to_sliced, unslice
from pfemfort_tpu_torch.sparse.spmv import spmv_ell, spmv_sliced

pytestmark = pytest.mark.cuda

# Kernel and plain version sum the same products in the same order; the
# kernel may fuse each multiply-add.
REL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lattice_system(n, device, dtype):
    """The reduced box_tet Poisson DIA system of the solve's main path."""
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
    from pfemfort_tpu_torch.drivers.common import build_reduced_assembler
    from pfemfort_tpu_torch.elements.geometry import to_element_minor
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(
        mesh, 1, dofmap,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        dtype, device)
    A, _ = assemble(torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                    dtype=dtype, device=device))
    return A


def _rel_err(y, y_ref):
    return float((y - y_ref).abs().max() / y_ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [6, 8, 10, 33])
def test_kernel_matches_plain_on_lattice_systems(cuda, n, dtype):
    A = _lattice_system(n, cuda, dtype)
    x = torch.as_tensor(np.random.default_rng(n).standard_normal(A.n_rows),
                        dtype=dtype, device=cuda)
    before = dia_spmv_cuda.kernel.launches
    y = dia_operator(A)(x)
    torch.cuda.synchronize()
    assert dia_spmv_cuda.kernel.launches == before + 1
    assert _rel_err(y, spmv_dia(A, x)) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_kernel_matches_plain_on_ragged_systems(cuda, n, dtype):
    rng = np.random.default_rng(n)
    offsets = (-(n + 5), -3, -1, 0, 2, 77, n + 2)
    A = DIAMatrix(vals=torch.as_tensor(rng.standard_normal((7, n)),
                                       dtype=dtype, device=cuda),
                  offsets=offsets, n_rows=n)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    y = dia_operator(A)(x)
    torch.cuda.synchronize()
    assert _rel_err(y, spmv_dia(A, x)) <= REL_TOL[dtype]


def test_kernel_rejects_what_it_does_not_take(cuda):
    A = DIAMatrix(vals=torch.ones(3, 8, device=cuda), offsets=(-1, 0, 1),
                  n_rows=8)
    op = dia_operator(A)
    with pytest.raises(TypeError):
        op(torch.ones(8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        op(torch.ones(9, device=cuda))
    with pytest.raises(ValueError):
        op(torch.ones(16, device=cuda)[::2])
    A16 = DIAMatrix(vals=A.vals.half(), offsets=A.offsets, n_rows=8)
    with pytest.raises(TypeError):
        dia_operator(A16)(torch.ones(8, dtype=torch.half, device=cuda))


def test_solve_on_the_card_matches_the_cpu(cuda):
    mesh, dbc = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    r_cpu = solve_poisson(mesh, dbc, device="cpu", dtype=torch.float64,
                          rtol=1e-10)
    before = dia_spmv_cuda.kernel.launches
    r_gpu = solve_poisson(mesh, dbc, device=cuda, dtype=torch.float64,
                          rtol=1e-10)
    assert dia_spmv_cuda.kernel.launches - before >= r_gpu.stats.iters
    assert r_gpu.stats.iters == r_cpu.stats.iters
    assert np.abs(r_gpu.u_full - r_cpu.u_full).max() <= 1e-10


def _permuted_box(n):
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(0).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _ordered_ell_system(n, device, dtype):
    """The permuted box_tet Poisson ELL system in the solve's row order."""
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
    from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
        build_reduced_assembler
    from pfemfort_tpu_torch.elements.geometry import to_element_minor
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    mesh, dbc = _permuted_box(n)
    dofmap = build_dofmap(mesh, 1, dbc)
    assemble = build_reduced_assembler(
        mesh, 1, dofmap,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        dtype, device)
    assert assemble.pattern.layout == "ell"
    ordering = build_ell_ordering(assemble.pattern,
                                  mesh.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, device)
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype, device=device)
    return assemble, ordering, coords


def _ragged_ell(n_rows, n_cols, k, device, dtype, seed, empty_every=0):
    """Random ELL with mixed sentinels (n_cols and 2 * n_rows + 128) in
    any slot: (sliced, x, the padded block); with empty_every, every such
    slice of 32 rows holds no valid slot."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_cols, (n_rows, k))
    pad = rng.random((n_rows, k)) < 0.3
    if empty_every:
        pad |= ((np.arange(n_rows) // SLICE) % empty_every == 1)[:, None]
    cols = np.where(pad, np.where(rng.random((n_rows, k)) < 0.5, n_cols,
                                  2 * n_rows + 128), cols)
    vals = np.where(pad, 0.0, rng.standard_normal((n_rows, k)))
    A = interop.ell_from_numpy(cols, vals, n_cols, device=device, dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(n_cols), dtype=dtype,
                        device=device)
    return ell_to_sliced(A), x, A


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 1, 1), (255, 255, 7), (257, 300, 16),
                                   (100_003, 110_010, 7), (4097, 4097, 33),
                                   (1000, 1000, 0), (100_003, 12_500, 1),
                                   (5000, 5000, 45)])
def test_ell_kernel_matches_plain_on_ragged_systems(cuda, shape, dtype):
    A, x, padded = _ragged_ell(*shape, cuda, dtype, seed=shape[0],
                               empty_every=3)
    before = ell_spmv_cuda.kernel.launches
    y = ell_spmv_cuda.ell_spmv(A, x)
    torch.cuda.synchronize()
    assert ell_spmv_cuda.kernel.launches == before + 1
    # against the sliced block and, independent of the layout, the padded one
    for y_ref in (spmv_sliced(A, x), spmv_ell(padded, x)):
        if shape[2] == 0:
            assert torch.equal(y, y_ref)
        else:
            assert _rel_err(y, y_ref) <= REL_TOL[dtype]
    # same bits again
    assert torch.equal(y, ell_spmv_cuda.ell_spmv(A, x))


def test_ell_kernel_past_int32_slot_offsets(cuda):
    """A block of 2.24e9 slots (18 GB in float32): slices past 2**31
    elements are read at their int64 offsets."""
    n_slices, width, n_cols = 70_000, 1_000, 4096
    n_rows = n_slices * SLICE - 7
    n_slots = n_slices * SLICE * width
    assert n_slots > 2 ** 31
    gen = torch.Generator(device=cuda).manual_seed(0)
    cols = torch.randint(0, n_cols, (n_slots,), dtype=torch.int32,
                         device=cuda, generator=gen)
    vals = torch.randn(n_slots, device=cuda, generator=gen)
    ptr = torch.arange(n_slices + 1, dtype=torch.int64,
                       device=cuda) * (SLICE * width)
    A = SlicedELL(cols=cols, vals=vals, slice_ptr=ptr, n_rows=n_rows,
                  n_cols=n_cols, max_width=width)
    x = torch.randn(n_cols, device=cuda, generator=gen)
    y = ell_spmv_cuda.ell_spmv(A, x)
    torch.cuda.synchronize()
    for s in (0, n_slices // 2, n_slices - 1):
        b = s * SLICE * width
        c = cols[b:b + SLICE * width].view(width, SLICE).long()
        v = vals[b:b + SLICE * width].view(width, SLICE)
        ref = (v * x[c]).sum(0)[:min(SLICE, n_rows - s * SLICE)]
        got = y[s * SLICE:s * SLICE + len(ref)]
        assert _rel_err(got, ref) <= 1e-4    # sum order differs (1000 terms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_matches_plain_on_the_ordered_mesh_system(cuda, dtype):
    assemble, ordering, coords = _ordered_ell_system(12, cuda, dtype)
    A, b = ordering.system(*assemble(coords))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A.n_cols),
                        dtype=dtype, device=cuda)
    y = ell_spmv_cuda.ell_spmv(A, x)
    torch.cuda.synchronize()
    assert _rel_err(y, spmv_sliced(A, x)) <= REL_TOL[dtype]


def test_ell_assembly_on_the_card_repeats_bit_for_bit(cuda):
    assemble, ordering, coords = _ordered_ell_system(12, cuda, torch.float32)
    (A1, b1), (A2, b2) = (ordering.system(*assemble(coords))
                          for _ in range(2))
    assert torch.equal(A1.vals, A2.vals) and torch.equal(b1, b2)


def test_ell_kernel_rejects_what_it_does_not_take(cuda):
    import dataclasses

    A, x, _ = _ragged_ell(64, 64, 4, cuda, torch.float32, seed=0)
    with pytest.raises(ValueError):
        ell_spmv_cuda.ell_spmv(dataclasses.replace(A, cols=A.cols.long()), x)
    with pytest.raises(ValueError):
        ell_spmv_cuda.ell_spmv(
            dataclasses.replace(A, vals=A.vals.repeat(2)[::2]), x)
    with pytest.raises(ValueError):
        ell_spmv_cuda.ell_spmv(
            dataclasses.replace(A, slice_ptr=A.slice_ptr.int()), x)
    with pytest.raises(ValueError):
        ell_spmv_cuda.ell_spmv(A, torch.ones(128, device=cuda)[::2])
    with pytest.raises(ValueError):
        ell_spmv_cuda.ell_spmv(A, x.cpu())
    with pytest.raises(TypeError, match="slice_ell"):     # unsliced
        ell_spmv_cuda.ell_spmv(unslice(A), x)


def test_ell_solve_on_the_card_matches_the_cpu(cuda):
    from pfemfort_tpu_torch.drivers.common import solve_implicit
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    mesh, dbc = _permuted_box(10)
    fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    r_cpu, r_gpu = (solve_implicit(mesh, 1, dbc, fn, device=d,
                                   dtype=torch.float64, rtol=1e-10,
                                   recover=False) for d in ("cpu", cuda))
    assert "order_s" in r_gpu.timings
    assert r_gpu.stats.iters == r_cpu.stats.iters
    assert np.abs(r_gpu.u_full - r_cpu.u_full).max() <= 1e-10


# ------------------------------------------------------------ elasticity


def _clamped(mesh):
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def _elasticity_system(case, device, dtype):
    """The assembled elasticity system in the solve's layout: 3D box_tet
    clamped on x=0 (flat DIA, 59 diagonals) or the 2D rect_tria with its
    nodes renumbered, as ELL in the solve's row order (K = 16)."""
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
    from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
        build_reduced_assembler
    from pfemfort_tpu_torch.elements.elasticity import dmat_3d, \
        dmat_plane_stress, elasticity_stiffness
    from pfemfort_tpu_torch.elements.geometry import to_element_minor

    if case == "3d":
        mesh, _ = generate.box_tet(0, 1, 10, 0, 1, 10, 0, 1, 10)
        D = dmat_3d(240.565, 0.3)
    else:
        mesh = generate.rect_tria(0, 2, 40, 0, 1, 20)
        perm = np.random.default_rng(0).permutation(mesh.n_node)
        mesh = mesh.renumbered(perm.astype(np.int64))
        D = dmat_plane_stress(240.565, 0.3)
    dbc = _clamped(mesh)
    dofmap = build_dofmap(mesh, mesh.ndim, dbc)
    assemble = build_reduced_assembler(
        mesh, mesh.ndim, dofmap,
        lambda c: elasticity_stiffness(c, mesh.etype, D), dtype, device)
    A, b = assemble(torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                    dtype=dtype, device=device))
    if case == "2d":
        ordering = build_ell_ordering(
            assemble.pattern, mesh.coords[dofmap.assy_for_soln // 2],
            dofmap.assy_for_soln % 2, device)
        A, b = ordering.system(A, b)
    return A


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_kernel_at_59_flat_diagonals(cuda, dtype):
    A = _elasticity_system("3d", cuda, dtype)
    assert len(A.offsets) == 59 and A.lattice is None
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(A.n_rows),
                        dtype=dtype, device=cuda)
    before = dia_spmv_cuda.kernel.launches
    y = dia_operator(A)(x)
    torch.cuda.synchronize()
    assert dia_spmv_cuda.kernel.launches == before + 1
    assert _rel_err(y, spmv_dia(A, x)) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_at_k16_two_dofs(cuda, dtype):
    A = _elasticity_system("2d", cuda, dtype)
    # the pattern's K = 16 is the TPU's padding; a tria3 node has at most
    # 7 nodes, 14 entries a row, and the sliced block is no wider
    assert A.max_width == 14
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(A.n_cols),
                        dtype=dtype, device=cuda)
    before = ell_spmv_cuda.kernel.launches
    y = ell_spmv_cuda.ell_spmv(A, x)
    torch.cuda.synchronize()
    assert ell_spmv_cuda.kernel.launches == before + 1
    assert _rel_err(y, spmv_sliced(A, x)) <= REL_TOL[dtype]
    assert torch.equal(y, ell_spmv_cuda.ell_spmv(A, x))


def test_elasticity_solve_on_the_card_matches_the_cpu(cuda):
    from pfemfort_tpu_torch import solve_elasticity

    mesh, _ = generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    dbc = _clamped(mesh)
    r_cpu, r_gpu = (solve_elasticity(mesh, dbc, 240.565, 0.3,
                                     bforce=(0.1, 0.0, 0.0), device=d,
                                     dtype=torch.float64, rtol=1e-10)
                    for d in ("cpu", cuda))
    assert abs(r_gpu.stats.iters - r_cpu.stats.iters) <= 1
    assert np.abs(r_gpu.u_full - r_cpu.u_full).max() <= 1e-10 * np.abs(
        r_cpu.u_full).max()


def _explicit(device, dtype, nsteps, init_state=None):
    from pfemfort_tpu_torch.drivers import presets as P
    from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics

    p = P.TRIA_EXPLICIT
    mesh = generate.rect_tria(0, 10, 100, 0, 2, 20)
    pulse = torch.tensor(p.pulse_t, dtype=dtype, device=device)
    bforce = torch.tensor(p.bforce, dtype=dtype, device=device)
    return explicit_dynamics(
        mesh, _clamped(mesh), p.E, p.nu, p.dens, p.dt, nsteps,
        bforce_fn=lambda t: bforce * torch.where(t <= pulse, 1.0, 0.0),
        probe_dofs=p.probe_dofs, device=device, dtype=dtype,
        init_state=init_state)


def test_explicit_on_the_card_repeats_and_resumes_bit_for_bit(cuda):
    from pfemfort_tpu_torch.dynamics.checkpoint import ExplicitState

    a, b = (_explicit(cuda, torch.float32, 600) for _ in range(2))
    half = _explicit(cuda, torch.float32, 300)
    rest = _explicit(cuda, torch.float32, 300, init_state=ExplicitState(
        disp=half.disp, disp_prev=half.disp_prev, velo=half.velo, step=300))
    for field in ("disp", "velo", "acce", "probe_history"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(rest.disp, a.disp)
    np.testing.assert_array_equal(
        np.concatenate([half.probe_history, rest.probe_history]),
        a.probe_history)
    assert np.abs(a.disp).max() > 0


def test_explicit_on_the_card_matches_the_cpu_in_float64(cuda):
    r_cpu, r_gpu = (_explicit(d, torch.float64, 200) for d in ("cpu", cuda))
    assert np.abs(r_gpu.disp - r_cpu.disp).max() <= 1e-12 * np.abs(
        r_cpu.disp).max()
    assert np.abs(r_gpu.probe_history - r_cpu.probe_history).max() <= \
        1e-12 * np.abs(r_cpu.probe_history).max()


# ---------------------------------------------------------------------------
# the preconditioners' blocks (B1 and B2 at the shapes they take there)
# ---------------------------------------------------------------------------

def _ordered_csr(n):
    """Host CSR of the ordered ELL system of `_ordered_ell_system`."""
    assemble, ordering, coords = _ordered_ell_system(n, "cpu",
                                                     torch.float64)
    A, b = ordering.system(*assemble(coords))
    A = unslice(A)
    cols, vals = A.cols.numpy(), A.vals.numpy()
    valid = cols < A.n_cols
    indptr = np.zeros(A.n_rows + 1, np.int64)
    np.cumsum(valid.sum(1), out=indptr[1:])
    return indptr, cols[valid], vals[valid], A.n_rows


def _on(A, device, dtype):
    if isinstance(A, DIAMatrix):
        return DIAMatrix(vals=A.vals.to(device, dtype), offsets=A.offsets,
                         n_rows=A.n_rows, lattice=A.lattice)
    return ell_to_sliced(ELLMatrix(cols=A.cols.to(device),
                                   vals=A.vals.to(device, dtype),
                                   n_cols=A.n_cols))


def _kernel_vs_plain(A, device, dtype, seed=0):
    A = _on(A, device, dtype)
    n = A.n_rows if isinstance(A, DIAMatrix) else A.n_cols
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                        dtype=dtype, device=device)
    if isinstance(A, DIAMatrix):
        kern, y = dia_spmv_cuda.kernel, None
        before = kern.launches
        y = dia_operator(A)(x)
        ref = spmv_dia(A, x)
    else:
        kern = ell_spmv_cuda.kernel
        before = kern.launches
        y = ell_spmv_cuda.ell_spmv(A, x)
        ref = spmv_sliced(A, x)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert _rel_err(y, ref) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_on_amg_transfers_and_ic0_triangles(cuda, dtype):
    """B2 on rectangular P0 (n_f x n_c) and P0^T (n_c x n_f) blocks of every
    level, and on IC(0)'s strictly triangular T and T^T (rows of sentinels
    only included)."""
    from pfemfort_tpu_torch.solve.amg import build_samg
    from pfemfort_tpu_torch.solve.ic0 import build_ic0_from_csr

    indptr, indices, vals, n = _ordered_csr(16)
    arrs, meta = build_samg(indptr, indices, vals, n, dtype=torch.float64,
                            coarsest_max=100, device="cpu")
    assert len(meta.sizes) >= 3
    for P in (*arrs.p0, *arrs.p0t, *arrs.p, *arrs.pt, *arrs.a):
        _kernel_vs_plain(P, cuda, dtype)
    ic0 = build_ic0_from_csr(indptr, indices, vals, n, dtype=torch.float64,
                             device="cpu")
    assert bool((ic0.t.cols >= n).all(1).any())      # the first row
    for T in (ic0.t, ic0.tt):
        _kernel_vs_plain(T, cuda, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_kernel_on_multigrid_levels_and_the_full_system(cuda, dtype):
    """B1 on every GMG level down to 3^3 nodes, on the full-system DIA with
    identity Dirichlet rows, and on a one-diagonal matrix."""
    from pfemfort_tpu_torch.assembly import structured as st
    from pfemfort_tpu_torch.assembly.fullsystem import zero_dirichlet_rows
    from pfemfort_tpu_torch.elements.geometry import to_element_minor
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
    from pfemfort_tpu_torch.solve.multigrid import build_gmg

    fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    mesh, dbc = generate.box_tet(0, 1, 16, 0, 1, 16, 0, 1, 16)
    bc = np.zeros(mesh.n_node, bool)
    bc[dbc[:, 0].astype(np.int64)] = True
    arrays, meta = build_gmg(mesh, 1, bc, fn, dtype=dtype, device=cuda,
                             coarsest_max_dof=27)
    assert meta.shapes[-1] == (3, 3, 3)
    for A in arrays.mats:
        _kernel_vs_plain(A, cuda, dtype)
    plan = st.build_structured_plan(16, 16, 16)
    Ke, Fe = fn(torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                dtype=dtype, device=cuda))
    A, _ = zero_dirichlet_rows(st.assemble_dia_structured(Ke, plan),
                               st.assemble_rhs_structured(Fe, plan),
                               torch.as_tensor(bc, device=cuda),
                               torch.zeros(mesh.n_node, dtype=dtype,
                                           device=cuda))
    _kernel_vs_plain(A, cuda, dtype)
    _kernel_vs_plain(DIAMatrix(vals=torch.rand(1, 2197, dtype=dtype),
                               offsets=(0,), n_rows=2197), cuda, dtype)


def test_routed_blocks_on_the_card_match_the_cpu(cuda):
    """Each form of solve/amg_device.py (B1, B2, dense) on the card gives
    the CPU's product."""
    from pfemfort_tpu_torch.solve.amg_device import build_device_ell, \
        device_ell_apply

    rng = np.random.default_rng(3)
    n = 20_000
    band = np.arange(n)[:, None] + np.array([-150, -1, 0, 1, 150])[None, :]
    cases = [(np.where((band >= 0) & (band < n), band, n), n, "dia"),
             (np.sort(rng.integers(0, n, (n, 8)), 1), n, "ell"),
             (rng.integers(0, 700, (n, 1)), 700, "ell"),
             (np.tile(np.arange(64), (64, 1)), 64, "dense")]
    for cols, n_cols, kind in cases:
        vals = rng.standard_normal(cols.shape)
        x = rng.standard_normal(n_cols)
        for dtype in (torch.float32, torch.float64):
            d_gpu = build_device_ell(cols, vals, n_cols, dtype=dtype,
                                     device=cuda)
            d_cpu = build_device_ell(cols, vals, n_cols, dtype=dtype,
                                     device="cpu")
            assert d_gpu.kind == d_cpu.kind == kind
            y = device_ell_apply(d_gpu, torch.as_tensor(x, dtype=dtype,
                                                        device=cuda))
            ref = device_ell_apply(d_cpu, torch.as_tensor(x, dtype=dtype))
            assert _rel_err(y.cpu(), ref) <= REL_TOL[dtype]


@pytest.mark.parametrize("case", ["cheby", "ic0", "amg", "mg", "refine",
                                  "amg_ell"])
def test_preconditioned_solves_on_the_card_match_the_cpu(cuda, case):
    """float64 solves on the card against the same solves on the CPU."""
    from pfemfort_tpu_torch.drivers.common import solve_implicit
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    n = 16 if case in ("mg", "amg_ell") else 12
    if case == "amg_ell":
        mesh, dbc = _permuted_box(n)
        fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
        run = lambda d: solve_implicit(mesh, 1, dbc, fn, device=d,
                                       dtype=torch.float64, rtol=1e-10,
                                       recover=False, precond="amg")
    else:
        mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
        kw = dict(refine=True) if case == "refine" else \
            dict(precond=case, bc_mode="full" if case == "mg" else "reduced")
        run = lambda d: solve_poisson(mesh, dbc, device=d,
                                      dtype=torch.float64, rtol=1e-10, **kw)
    r_cpu, r_gpu = run("cpu"), run(cuda)
    assert r_gpu.stats.converged
    slack = 0 if case in ("mg", "refine") else 1
    assert abs(r_gpu.stats.iters - r_cpu.stats.iters) <= slack
    assert np.abs(r_gpu.u_full - r_cpu.u_full).max() <= 1e-9
    assert r_gpu.timings.get("precond_used") == r_cpu.timings.get(
        "precond_used")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hybrid_on_the_card_matches_plain(cuda, dtype):
    """The hybrid split (sparse/hybrid.py) of a banded block with far
    couplings: B1 on its dense diagonals and B2 on the remainder, both
    launched, against the same split on the CPU (the plain versions)."""
    from pfemfort_tpu_torch.sparse.hybrid import apply_hybrid, \
        build_hybrid_plan, hybrid_from_plan

    rng = np.random.default_rng(11)
    n = 50_000
    cols = np.concatenate([np.arange(n)[:, None] + [-300, -1, 0, 1, 300],
                           rng.integers(0, n, (n, 3))], 1)
    cols = np.sort(np.where((cols < 0) | (cols >= n), n, cols), 1)
    cols[:, 1:][cols[:, 1:] == cols[:, :-1]] = n
    vals = np.where(cols < n, rng.standard_normal(cols.shape), 0.0)
    plan = build_hybrid_plan(cols, n)
    assert plan.D == 5 and plan.nnz_rem > 0
    x = rng.standard_normal(n)
    H_gpu = hybrid_from_plan(plan, vals, dtype, cuda)
    H_cpu = hybrid_from_plan(plan, vals, dtype, "cpu")
    before = (dia_spmv_cuda.kernel.launches, ell_spmv_cuda.kernel.launches)
    y = apply_hybrid(H_gpu, torch.as_tensor(x, dtype=dtype, device=cuda))
    torch.cuda.synchronize()
    assert (dia_spmv_cuda.kernel.launches, ell_spmv_cuda.kernel.launches) \
        == (before[0] + 1, before[1] + 1)
    ref = apply_hybrid(H_cpu, torch.as_tensor(x, dtype=dtype))
    assert _rel_err(y.cpu(), ref) <= REL_TOL[dtype]


def test_float32_ell_solve_on_the_card_runs_pure_b1(cuda):
    """A renumbered box in float32: the hybrid in lex order is 15 dense
    diagonals and no remainder, so the card launches B1 only."""
    from pfemfort_tpu_torch.drivers.common import solve_implicit
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    mesh, dbc = _permuted_box(16)
    fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    run = lambda d: solve_implicit(mesh, 1, dbc, fn, device=d,
                                   dtype=torch.float32, rtol=1e-6,
                                   recover=False)
    r_cpu = run("cpu")
    before = (dia_spmv_cuda.kernel.launches, ell_spmv_cuda.kernel.launches)
    r_gpu = run(cuda)
    b1 = dia_spmv_cuda.kernel.launches - before[0]
    assert ell_spmv_cuda.kernel.launches == before[1]
    assert b1 >= r_gpu.stats.iters
    assert r_gpu.timings["hybrid_diagonals"] == 15
    assert abs(r_gpu.stats.iters - r_cpu.stats.iters) <= 1
    assert np.abs(r_gpu.u_full - r_cpu.u_full).max() <= 1e-4


def test_highprec_on_the_card_matches_the_cpu(cuda):
    from pfemfort_tpu_torch.solve.highprec import solve_box_poisson_1e8

    mesh, dbc = generate.box_tet(0, 1, 24, 0, 1, 24, 0, 1, 24)
    (u_c, s_c, _), (u_g, s_g, _) = (solve_box_poisson_1e8(mesh, dbc, device=d)
                                    for d in ("cpu", cuda))
    assert s_g.converged and s_g.relres <= 1e-8
    assert s_g.outer_iters == s_c.outer_iters
    assert np.abs(u_g - u_c).max() <= 1e-9
    assert np.abs(u_g - (mesh.coords ** 2).sum(1)).max() < 1e-7


def test_matrix_free_on_the_card_matches_the_cpu(cuda):
    mesh, dbc = generate.box_tet(0, 1, 24, 0, 1, 24, 0, 1, 24)
    r_cpu, r_gpu = (solve_poisson(mesh, dbc, device=d, dtype=torch.float64,
                                  rtol=1e-10, matrix_free=True)
                    for d in ("cpu", cuda))
    assert r_gpu.stats.converged
    assert abs(r_gpu.stats.iters - r_cpu.stats.iters) <= 1
    assert np.abs(r_gpu.u_full - r_cpu.u_full).max() <= 1e-10


def test_cfd_on_the_card_matches_the_cpu(cuda):
    from pfemfort_tpu_torch.cfd import fractional_step_ns

    mesh = generate.rect_tria(0, 1, 16, 0, 1, 16)
    x, y = mesh.coords.T
    wall = np.isclose(x, 0) | np.isclose(x, 1) | np.isclose(y, 0)
    lid = np.isclose(y, 1) & ~wall
    bcs = np.asarray([[n, c, 1.0 if (lid[n] and c == 0) else 0.0]
                      for n in np.nonzero(wall | lid)[0] for c in (0, 1)])
    r_cpu, r_gpu = (fractional_step_ns(mesh, bcs, nu_visc=0.05, dt=2e-3,
                                       nsteps=20, dtype=torch.float64,
                                       device=d) for d in ("cpu", cuda))
    assert np.abs(r_gpu.velocity - r_cpu.velocity).max() <= 1e-10
    assert np.abs(r_gpu.div_history - r_cpu.div_history).max() <= 1e-9


# ---- B1's halo entry (the in-shard product of the sharded DIA route) ------

def _halo_block(rng, P, offsets, w, dtype, device):
    from pfemfort_tpu_torch.sparse.dia import DIAMatrix

    A = DIAMatrix(vals=torch.as_tensor(rng.standard_normal((len(offsets), P)),
                                       dtype=dtype, device=device),
                  offsets=tuple(offsets), n_rows=P)
    vec = lambda n: torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                    device=device)
    return A, vec(P), vec(w), vec(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("halos", ["both", "none", "left", "right"])
@pytest.mark.parametrize("shape", ["lattice", "w = P", "59 diagonals"])
def test_halo_kernel_matches_plain(cuda, shape, halos, dtype):
    """dia_spmv_halo against spmv_dia_halo_local (the plain form
    parallel/halo.py sums in offset order): a 15-diagonal lattice stencil
    shard, a block whose halo is as wide as its rows, and 59 diagonals
    (the 3D elasticity census); None halos read zeros."""
    from pfemfort_tpu_torch.parallel.halo import halo_width
    from pfemfort_tpu_torch.sparse.dia import spmv_dia_halo_local

    rng = np.random.default_rng(7)
    if shape == "lattice":
        plane, row = 23 * 23, 23
        offsets = sorted({dz * plane + dy * row + dx
                          for dz, dy, dx in [(0, 0, 0), (0, 0, 1), (0, 1, 0),
                                             (0, 1, 1), (1, 0, 0), (1, 0, 1),
                                             (1, 1, 0), (1, 1, 1)]}
                         | {-(dz * plane + dy * row + dx)
                            for dz, dy, dx in [(0, 0, 1), (0, 1, 0),
                                               (0, 1, 1), (1, 0, 0),
                                               (1, 0, 1), (1, 1, 0),
                                               (1, 1, 1)]})
        P = 7 * plane
    elif shape == "w = P":
        offsets, P = (-40, -1, 0, 1, 40), 40
    else:
        offsets = sorted({int(o) for o in rng.choice(
            np.arange(-3000, 3001), 58, replace=False)} | {0})
        offsets = (offsets + [3001])[:59]
        P = 20_000
    w = halo_width(tuple(offsets))
    if shape == "w = P":
        assert w == P
    A, x, left, right = _halo_block(rng, P, offsets, w, dtype, cuda)
    left = left if halos in ("both", "left") else None
    right = right if halos in ("both", "right") else None
    before = dict(dia_spmv_cuda.kernel.entry_launches)
    y = dia_spmv_cuda.dia_spmv_halo(A, x, left, right)
    torch.cuda.synchronize()
    entry = "dia_spmv_halo_" + str(dtype)[-7:].replace("float", "f")
    assert dia_spmv_cuda.kernel.entry_launches[entry] == \
        before.get(entry, 0) + 1
    assert _rel_err(y, spmv_dia_halo_local(A, x, left, right)) <= \
        REL_TOL[dtype]


def test_halo_kernel_rejects_what_it_does_not_take(cuda):
    from pfemfort_tpu_torch.sparse.dia import DIAMatrix

    A = DIAMatrix(vals=torch.ones(3, 16, device=cuda), offsets=(-8, 0, 8),
                  n_rows=16)
    x = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="largest"):     # w below the reach
        dia_spmv_cuda.dia_spmv_halo(A, x, torch.ones(4, device=cuda), None)
    with pytest.raises(TypeError):
        dia_spmv_cuda.dia_spmv_halo(A, x, torch.ones(8, device=cuda,
                                                     dtype=torch.float64),
                                    None)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv_cuda.dia_spmv_halo(A, x, torch.ones(16, device=cuda)[::2],
                                    None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_kernel_on_a_ghost_extended_block(cuda, dtype):
    """B2 on one rank's block of the sharded ELL route (parallel/dist_ell.py):
    rank 1 of a 4-way RCB partition of a scrambled box, P rows by P + S*Wx
    columns, its padding on the sentinel column P + S*Wx, random values
    and a random x, the ghost slots included."""
    from pfemfort_tpu_torch.parallel.dist_ell import local_columns, \
        reader_plan
    from pfemfort_tpu_torch.parallel.shard import build_sharded_system
    from pfemfort_tpu_torch.sparse.sliced import slice_ell

    mesh, dbc = _permuted_box(12)
    S, r = 4, 1
    sys_ = build_sharded_system(mesh, 1, dbc, S, method="rcb", layout="ell")
    P, n_rows = sys_.rows_per_shard, sys_.n_rows_padded
    cols = torch.as_tensor(sys_.pattern.ell_cols, device=cuda)
    plans = [reader_plan(cols[t * P:(t + 1) * P], t, S, n_rows)
             for t in range(S)]
    wx = 8 * -(-max(int(p.counts.max()) for p in plans) // 8)
    c = local_columns(cols[r * P:(r + 1) * P], plans[r], r, S, n_rows, wx)
    n_cols = P + S * wx
    assert int((c >= P).sum()) and int((c == n_cols).sum())
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(rng.standard_normal(tuple(c.shape)), dtype=dtype,
                           device=cuda)
    A = slice_ell(c, n_cols).pack(vals)
    x = torch.as_tensor(rng.standard_normal(n_cols), dtype=dtype,
                        device=cuda)
    before = ell_spmv_cuda.kernel.launches
    y = ell_spmv_cuda.ell_spmv(A, x)
    torch.cuda.synchronize()
    assert ell_spmv_cuda.kernel.launches == before + 1
    padded = ELLMatrix(cols=c, vals=torch.where(c < n_cols, vals, 0.0),
                       n_cols=n_cols)
    for y_ref in (spmv_sliced(A, x), spmv_ell(padded, x)):
        assert _rel_err(y, y_ref) <= REL_TOL[dtype]


def _rank_hybrid(S, r, device, dtype):
    """Rank r's per-rank hybrid (parallel/dist_ell.py) of an S-way RCB
    partition of a scrambled box_tet n=12, the diagonals picked from every
    rank's census as the float32 ELL route picks them, random values.
    Returns (the hybrid, the rank's (P, K) ghost-extended columns, its
    values, n_cols = P + S*Wx)."""
    from pfemfort_tpu_torch.parallel.dist_ell import hybrid_counts, \
        hybrid_offsets, hybrid_split, local_columns, reader_plan
    from pfemfort_tpu_torch.parallel.shard import build_sharded_system
    from pfemfort_tpu_torch.sparse.hybrid import hybrid_layout

    mesh, dbc = _permuted_box(12)
    sys_ = build_sharded_system(mesh, 1, dbc, S, method="rcb", layout="ell")
    P, n_rows = sys_.rows_per_shard, sys_.n_rows_padded
    cols = torch.as_tensor(sys_.pattern.ell_cols)
    blocks = [cols[t * P:(t + 1) * P] for t in range(S)]
    plans = [reader_plan(c, t, S, n_rows) for t, c in enumerate(blocks)]
    wx = 8 * -(-max(max(int(p.counts.max()) for p in plans), 1) // 8)
    host = [local_columns(c, plans[t], t, S, n_rows, wx).numpy()
            for t, c in enumerate(blocks)]
    n_cols = P + S * wx
    plan = hybrid_split(host[r], hybrid_offsets(
        sum(hybrid_counts(c) for c in host), S), n_cols)
    vals = torch.as_tensor(np.random.default_rng(7).standard_normal(
        host[r].shape), dtype=dtype, device=device)
    return hybrid_layout(plan, device).pack(vals), host[r], vals, n_cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["rank 1 of 4", "world size 1"])
def test_rank_hybrid_parts_match_plain(cuda, case, dtype):
    """The two parts of a rank's hybrid: B1 on the dense local diagonals
    and the rank's own x, B2 on the remainder (ghost columns included) and
    the ghost-extended x, each against its plain version, and their sum
    against the plain product of the rank's whole ghost-extended block.
    At rank 1 of 4 the remainder holds the ghosts; at world size 1 the
    lex-ordered rank is the lattice stencil and the remainder is empty."""
    from pfemfort_tpu_torch.sparse.hybrid import HybridMatrix

    S, r = (4, 1) if case == "rank 1 of 4" else (1, 0)
    H, cols, vals, n_cols = _rank_hybrid(S, r, cuda, dtype)
    assert isinstance(H, HybridMatrix) and H.dia is not None
    assert (H.rem is None) == (S == 1)
    P = H.n_rows
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(n_cols),
                        dtype=dtype, device=cuda)
    before = (dia_spmv_cuda.kernel.launches, ell_spmv_cuda.kernel.launches)
    y = dia_spmv_cuda.dia_spmv(H.dia, x[:P])
    torch.cuda.synchronize()
    assert dia_spmv_cuda.kernel.launches == before[0] + 1
    assert _rel_err(y, spmv_dia(H.dia, x[:P])) <= REL_TOL[dtype]
    if H.rem is not None:
        assert int((H.rem.cols >= P).logical_and(H.rem.cols < n_cols).sum())
        y_rem = ell_spmv_cuda.ell_spmv(H.rem, x)
        torch.cuda.synchronize()
        assert ell_spmv_cuda.kernel.launches == before[1] + 1
        assert _rel_err(y_rem, spmv_sliced(H.rem, x)) <= REL_TOL[dtype]
        y = y + y_rem
    c = torch.as_tensor(cols, dtype=torch.int32, device=cuda)
    whole = ELLMatrix(cols=c, vals=torch.where(c < n_cols, vals, 0.0),
                      n_cols=n_cols)
    assert _rel_err(y, spmv_ell(whole, x)) <= REL_TOL[dtype]


def _b1_block(shape, device, dtype):
    """A B1 block at the shapes of the bit-equality cases: the lattice
    system, the 59-diagonal 3D elasticity census, a ragged block whose
    offsets reach past +-n, a hexa8 3D elasticity census (99 diagonals,
    the most a generated mesh gives), an empty interior, w = P and a
    single row."""
    rng = np.random.default_rng(11)
    if shape == "lattice":
        return _lattice_system(12, device, dtype)
    if shape == "59 diagonals":
        return _elasticity_system("3d", device, dtype)
    if shape == "99 diagonals":
        from pfemfort_tpu_torch.assembly.pattern import build_pattern
        from pfemfort_tpu_torch.dofs.dofmap import build_dofmap

        mesh = generate.box_hexa(0, 1, 6, 0, 1, 6, 0, 1, 6)
        dm = build_dofmap(mesh, 3, _clamped(mesh))
        offsets = build_pattern(dm.elem_dof,
                                int(dm.elem_dof.max()) + 1).dia_offsets
        n = int(dm.elem_dof.max()) + 1
    else:
        offsets, n = {"ragged": ((-(40_000 + 5), -3, 7, 0, -1, 77, 40_002),
                                 40_000),
                      "empty interior": ((-700, 0, 5, 700), 1_000),
                      "w = P": ((-40, -1, 0, 1, 40), 40),
                      "single row": ((-1, 0, 1), 1)}[shape]
    return DIAMatrix(vals=torch.as_tensor(
        rng.standard_normal((len(offsets), n)), dtype=dtype, device=device),
        offsets=tuple(offsets), n_rows=n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ["lattice", "59 diagonals", "ragged",
                                   "99 diagonals", "empty interior", "w = P",
                                   "single row"])
def test_b1_entries_are_one_body_bit_for_bit(cuda, shape, dtype):
    """dia_spmv and dia_spmv_halo(..., None, None) are one kernel body:
    the same bits on the same block, the same bits on a second launch,
    and the plain version's values; each launch counted on its entry."""
    A = _b1_block(shape, cuda, dtype)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(A.n_rows),
                        dtype=dtype, device=cuda)
    suffix = "f32" if dtype == torch.float32 else "f64"
    before = dict(dia_spmv_cuda.kernel.entry_launches)
    y = dia_spmv_cuda.dia_spmv(A, x)
    y_halo = dia_spmv_cuda.dia_spmv_halo(A, x, None, None)
    y_again = dia_spmv_cuda.dia_spmv(A, x)
    torch.cuda.synchronize()
    after = dia_spmv_cuda.kernel.entry_launches
    assert after[f"dia_spmv_{suffix}"] == before.get(f"dia_spmv_{suffix}",
                                                     0) + 2
    assert after[f"dia_spmv_halo_{suffix}"] == before.get(
        f"dia_spmv_halo_{suffix}", 0) + 1
    assert torch.equal(y, y_halo) and torch.equal(y, y_again)
    assert _rel_err(y, spmv_dia(A, x)) <= REL_TOL[dtype]


@pytest.mark.parametrize("shape", ["empty interior", "w = P", "single row"])
def test_b1_halo_entry_on_edge_plans(cuda, shape):
    """Blocks with no interior block, a halo as wide as the rows, one row:
    the halo entry with both halos against its plain version."""
    from pfemfort_tpu_torch.sparse.dia import spmv_dia_halo_local

    A = _b1_block(shape, cuda, torch.float64)
    w = max(max(A.offsets), -min(A.offsets))
    rng = np.random.default_rng(4)
    x, left, right = (torch.as_tensor(rng.standard_normal(k),
                                      dtype=torch.float64, device=cuda)
                      for k in (A.n_rows, w, w))
    y = dia_spmv_cuda.dia_spmv_halo(A, x, left, right)
    assert _rel_err(y, spmv_dia_halo_local(A, x, left, right)) <= \
        REL_TOL[torch.float64]


def test_b1_raises_above_its_diagonal_cap(cuda):
    """More diagonals than the kernel's launch parameters hold raise,
    naming the count, on both entries; the cap itself runs."""
    n, D = 500, dia_spmv_cuda.MAX_DIAGONALS
    for count, ok in ((D, True), (D + 1, False)):
        offsets = tuple(range(-(count // 2), count - count // 2))
        A = DIAMatrix(vals=torch.ones(count, n, device=cuda),
                      offsets=offsets, n_rows=n)
        x = torch.ones(n, device=cuda)
        if ok:
            assert torch.equal(dia_spmv_cuda.dia_spmv(A, x), spmv_dia(A, x))
            continue
        with pytest.raises(ValueError, match=str(count)):
            dia_spmv_cuda.dia_spmv(A, x)
        with pytest.raises(ValueError, match=str(count)):
            dia_spmv_cuda.dia_spmv_halo(A, x, None, None)


# ---------------------------------------------------------------------------
# the distributed preconditioners and the sharded explicit loop, at world
# size 1 (a one-rank NCCL group)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl1(cuda):
    from pfemfort_tpu_torch.parallel import multihost

    multihost.initialize(device="cuda")
    yield cuda
    multihost.shutdown()


def test_dist_mg_on_the_card_matches_single_device_gmg(nccl1):
    """At world size 1 the distributed multigrid is the single-device
    full-system GMG (levels 1+ the same hierarchy, the padding planes
    decoupled identity rows): the same count, u within 1e-10 in float64;
    every fine product is a launch of B1's halo entry."""
    from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    mesh, dbc = generate.box_tet(0, 1, 16, 0, 1, 16, 0, 1, 16)
    ref = solve_poisson(mesh, dbc, device="cpu", dtype=torch.float64,
                        rtol=1e-8, bc_mode="full", precond="mg")
    dia_spmv_cuda.kernel.entry_launches.clear()
    before_b2 = ell_spmv_cuda.kernel.launches
    res = solve_implicit_sharded(
        mesh, 1, dbc, lambda c: poisson_element_matrices(c, "tetra4",
                                                         source=-6.0),
        dtype=torch.float64, rtol=1e-8, maxiter=100, precond="mg",
        device=nccl1)
    halo = sum(v for e, v in dia_spmv_cuda.kernel.entry_launches.items()
               if "halo" in str(e))
    assert res.timings["distributed_mg"] and res.stats.converged
    assert res.stats.iters == ref.stats.iters
    assert np.abs(res.u_full - ref.u_full).max() <= 1e-10
    assert halo >= 3 * res.stats.iters
    assert ell_spmv_cuda.kernel.launches == before_b2


def test_dist_amg_blocks_on_the_card_match_plain(nccl1):
    """B2 on a rank's P0_s and P0_s^T blocks of a distributed SA-AMG
    hierarchy (a renumbered box_tet n=12), float32 and float64, against
    spmv_sliced on the same blocks."""
    from pfemfort_tpu_torch.parallel.shard import build_sharded_system
    from pfemfort_tpu_torch.solve.amg import build_dist_samg

    mesh, dbc = _permuted_box(12)
    sys_ = build_sharded_system(mesh, 1, dbc, 4, method="rcb", layout="ell")
    pat = sys_.pattern
    rng = np.random.default_rng(5)
    # an SPD stand-in on the pattern: the graph Laplacian plus the identity
    deg = np.diff(pat.indptr)
    rows = np.repeat(np.arange(pat.n_rows), deg)
    vals = np.where(pat.indices == rows, deg.astype(np.float64)[rows] + 1.0,
                    -1.0)
    for dtype in (torch.float32, torch.float64):
        amg = build_dist_samg(pat.indptr, pat.indices, vals,
                              sys_.n_rows_padded, 4, 1, dtype=dtype,
                              device=nccl1)
        assert amg is not None
        for A in (amg.p0, amg.p0t):
            x = torch.as_tensor(rng.standard_normal(A.n_cols), dtype=dtype,
                                device=nccl1)
            before = ell_spmv_cuda.kernel.launches
            y = ell_spmv_cuda.ell_spmv(A, x)
            torch.cuda.synchronize()
            assert ell_spmv_cuda.kernel.launches == before + 1
            assert _rel_err(y, spmv_sliced(A, x)) <= REL_TOL[dtype]


def test_float32_ell_route_on_the_card_runs_the_rank_hybrid(nccl1):
    """The sharded ELL route at world size 1 in float32: the per-rank
    hybrid, which for a renumbered box is the 15 lattice diagonals on B1
    and no remainder, so B1 launches once an iteration and once for r0,
    B2 not at all; against the float64 route (B2) on the CPU's numbers of
    the same system."""
    from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    mesh, dbc = _permuted_box(16)
    fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    before = (dia_spmv_cuda.kernel.launches, ell_spmv_cuda.kernel.launches)
    r32 = solve_implicit_sharded(mesh, 1, dbc, fn, dtype=torch.float32,
                                 rtol=1e-6, recover=False, device=nccl1)
    b1 = dia_spmv_cuda.kernel.launches - before[0]
    b2 = ell_spmv_cuda.kernel.launches - before[1]
    r64 = solve_implicit_sharded(mesh, 1, dbc, fn, dtype=torch.float64,
                                 rtol=1e-6, recover=False, device=nccl1)
    t = r32.timings
    assert t["inshard_kernel"] == "hybrid" and t["hybrid_diagonals"] == 15
    assert t["hybrid_nnz_rem"] == 0
    assert r64.timings["inshard_kernel"] == "ell_spmv"
    assert (b1, b2) == (r32.stats.iters + 1, 0)
    assert abs(r32.stats.iters - r64.stats.iters) <= 1
    assert np.abs(r32.u_full - r64.u_full).max() <= 1e-4


def test_sharded_explicit_at_world_size_1_is_the_single_device_loop(nccl1):
    """One rank owns every element in the single-device loop's order, so
    the float32 result has its bits; float64 matches the CPU to 1e-12."""
    from pfemfort_tpu_torch.drivers import presets as P
    from pfemfort_tpu_torch.dynamics.sharded import explicit_dynamics_sharded

    p = P.TRIA_EXPLICIT
    mesh = generate.rect_tria(0, 10, 100, 0, 2, 20)

    def run(dtype, device, sharded):
        pulse = torch.tensor(p.pulse_t, dtype=dtype, device=device)
        bforce = torch.tensor(p.bforce, dtype=dtype, device=device)
        kw = dict(bforce_fn=lambda t: bforce * torch.where(t <= pulse, 1.0,
                                                           0.0),
                  probe_dofs=p.probe_dofs, device=device, dtype=dtype)
        if sharded:
            return explicit_dynamics_sharded(mesh, _clamped(mesh), p.E, p.nu,
                                             p.dens, p.dt, 300, **kw)
        return _explicit(device, dtype, 300)

    a = run(torch.float32, nccl1, True)
    b = run(torch.float32, nccl1, False)
    for field in ("disp", "velo", "acce", "probe_history"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    c = run(torch.float64, nccl1, True)
    d = run(torch.float64, "cpu", False)
    assert np.abs(c.disp - d.disp).max() <= 1e-12 * np.abs(d.disp).max()


def test_device_rcb_on_the_card_matches_the_cpu(cuda):
    from pfemfort_tpu_torch.parallel.dist_partition import \
        rcb_partition_device

    mesh, _ = generate.box_tet(0, 1, 16, 0, 1, 16, 0, 4, 48)
    cent = mesh.elem_centroids()
    for k in (2, 7, 8):
        np.testing.assert_array_equal(
            rcb_partition_device(cent, k, device=cuda).cpu().numpy(),
            rcb_partition_device(cent, k, device="cpu").numpy())


def test_dryrun_on_the_card_at_world_size_1(nccl1):
    from pfemfort_tpu_torch.dryrun import dryrun

    iters = dryrun(device=nccl1, dtype=torch.float32, verbose=False)
    assert set(iters) == {"halo/dia", "dist/ell", "dist_mg", "dist_amg"}


def test_bench_at_a_toy_size_on_the_card(cuda, tmp_path, capsys):
    """The bench harness (pfemfort_tpu_torch/bench.py) at n=12 on the card:
    every stage true, B1 launched on the flagship's every CG iteration,
    kernel times from CUDA events beside their bound."""
    import json

    from pfemfort_tpu_torch import bench

    detail = tmp_path / "detail.json"
    rc = bench.main(["12", "0", "0", "--device", "cuda", "--detail",
                     str(detail)])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    det = json.loads(detail.read_text())
    assert rc == 0 and last["stages"] and all(last["stages"].values()), \
        {k: det[k].get("error") for k in last["stages"]}
    fl = det["flagship"]
    assert fl["launches"]["jacobi"]["dia_spmv"] >= fl["cg_iters"]
    assert fl["spmv"]["clock"] == "cuda_events"
    assert 0 < fl["spmv"]["bound_us"] <= 1.05 * fl["spmv"]["device_us"]
    assert det["amg"]["launches"]["amg"]["ell_spmv"] > 0
