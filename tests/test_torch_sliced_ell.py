"""The sliced ELL layout of kernel B2 (sparse/sliced.py) and its plain SpMV.

`slice_ell` lays an (N, K) ELL pattern out in slices of 32 rows, each as
wide as its longest row, slot-major.  Held here on the CPU:
  * its invariants: no slice wider than its longest row, each row's valid
    slots in their original order whatever the sentinels' places, pad rows
    and short rows' tails holding sentinels; empty slices, K = 1,
    n % 32 != 0 and rectangular blocks;
  * `spmv_sliced` against JAX `spmv_ell` and the slot-gather plan run by
    `apply_slotgather_reference` (how the JAX package's own tests run
    kernel B2 on the CPU), 1e-12 in float64, with both sentinels (n_cols
    and a row ordering's 2 * n_rows + 128);
  * bit equality with the port's `spmv_ell` in float64: both add each
    row's products in slot order;
  * the one-gather pack of an assembly (an EllOrdering's and the hybrid
    remainder's composed sources) against slicing the values gathered the
    two-step way.
The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.sparse import spmv as jspmv
from pfemfort_tpu.sparse.formats import ELLMatrix as JELL
from pfemfort_tpu.sparse.slotgather import apply_slotgather_reference, \
    build_slotgather_plan
from pfemfort_tpu_torch import generate, interop
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.solve.amg_device import build_device_ell
from pfemfort_tpu_torch.sparse import ell_spmv_cuda, hybrid
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.ordering import permuted_sorted_cols
from pfemfort_tpu_torch.sparse.sliced import SLICE, ell_to_sliced, \
    slice_ell, sliced_slots, unslice
from pfemfort_tpu_torch.sparse.spmv import extract_diagonal, \
    sliced_diagonal, spmv_ell, spmv_sliced
from test_torch_general import scrambled_delaunay

torch.set_num_threads(1)

# Same products in float64; JAX may sum a row's K slots in another order.
RTOL = 1e-12


def _random_ell(n_rows, n_cols, k, sentinel, seed, empty_slices=False):
    """Ragged random ELL whose sentinel slots sit anywhere in a row (not
    only at its end) and hold zero values; with empty_slices, every third
    slice of 32 rows has no valid slot."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_cols, (n_rows, k))
    pad = rng.random((n_rows, k)) < 0.35
    if empty_slices:
        pad |= ((np.arange(n_rows) // SLICE) % 3 == 1)[:, None]
    cols = np.where(pad, sentinel, cols)
    vals = np.where(pad, 0.0, rng.standard_normal((n_rows, k)))
    return cols, vals, rng.standard_normal(n_cols)


CASES = {
    # name: (n_rows, n_cols, K, sentinel kind, empty slices)
    "square_n_cols_sentinel": (300, 300, 7, "n_cols", False),
    "square_ordered_sentinel": (300, 300, 7, "ordered", False),
    "rectangular_n_cols_sentinel": (257, 400, 5, "n_cols", False),
    "rectangular_ordered_sentinel": (257, 400, 9, "ordered", False),
    "k1_rectangular_tall": (1001, 125, 1, "n_cols", False),
    "empty_slices": (200, 200, 6, "n_cols", True),
    "one_row": (1, 3, 4, "ordered", False),
}


def _case(name):
    n_rows, n_cols, k, kind, empty = CASES[name]
    sentinel = n_cols if kind == "n_cols" else 2 * n_rows + 128
    return _random_ell(n_rows, n_cols, k, sentinel, seed=len(name),
                       empty_slices=empty)


def _sliced(cols, vals, n_cols):
    return ell_to_sliced(interop.ell_from_numpy(
        cols, vals, n_cols, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("case", list(CASES))
def test_layout_invariants(case):
    cols, vals, x = _case(case)
    n_rows, n_cols = cols.shape[0], len(x)
    S = _sliced(cols, vals, n_cols)
    valid = cols < n_cols
    count = np.zeros(-(-n_rows // SLICE) * SLICE, np.int64)
    count[:n_rows] = valid.sum(1)
    longest = count.reshape(-1, SLICE).max(1)
    ptr = S.slice_ptr.numpy()
    assert S.slice_ptr.dtype == torch.int64 and S.cols.dtype == torch.int32
    assert ptr[0] == 0 and (ptr % SLICE == 0).all()
    # each slice exactly as wide as its longest row, never wider
    np.testing.assert_array_equal(np.diff(ptr) // SLICE, longest)
    assert S.max_width == longest.max() and S.n_slots == ptr[-1]
    assert S.n_slots == sliced_slots(cols, n_cols)
    if CASES[case][4]:
        assert (longest[1::3] == 0).all()
    # each row: its valid slots in their original order, then sentinels
    E = unslice(S)
    ec, ev = E.cols.numpy(), E.vals.numpy()
    for r in range(n_rows):
        c = int(valid[r].sum())
        np.testing.assert_array_equal(ec[r, :c], cols[r][valid[r]])
        np.testing.assert_array_equal(ev[r, :c], vals[r][valid[r]])
        assert (ec[r, c:] >= n_cols).all() and (ev[r, c:] == 0).all()
    # the rows past n_rows of the last slice hold the sentinel n_cols
    s = S.n_slices - 1
    w = (ptr[s + 1] - ptr[s]) // SLICE
    tail = S.cols.numpy()[ptr[s]:ptr[s + 1]].reshape(w, SLICE)
    assert (tail[:, n_rows - s * SLICE:] == n_cols).all()


@pytest.mark.parametrize("case", list(CASES))
def test_spmv_sliced_matches_jax_and_the_slotgather_reference(case):
    cols, vals, x = _case(case)
    n_rows, n_cols = cols.shape[0], len(x)
    Aj = JELL(cols=jnp.asarray(cols.astype(np.int32)), vals=jnp.asarray(vals),
              n_cols=n_cols)
    y_jax = np.asarray(jspmv.spmv_ell(Aj, jnp.asarray(x)))
    plan = build_slotgather_plan(cols, n_rows, n_cols=n_cols)
    valsv = np.where(plan.src >= 0,
                     vals.reshape(-1)[np.clip(plan.src, 0, None)], 0.0)
    y_sg = apply_slotgather_reference(plan, valsv, x)
    y = spmv_sliced(_sliced(cols, vals, n_cols), torch.as_tensor(x)).numpy()
    scale = max(np.abs(y_jax).max(), 1e-30)
    assert np.abs(y - y_jax).max() <= RTOL * scale
    assert np.abs(y - y_sg).max() <= RTOL * scale


@pytest.mark.parametrize("case", list(CASES))
def test_spmv_sliced_equals_spmv_ell_bit_for_bit(case):
    """The slot-order guarantee: a row's products are added in the same
    order in both layouts, so float64 results are identical."""
    cols, vals, x = _case(case)
    A = interop.ell_from_numpy(cols, vals, len(x), dtype=torch.float64,
                               device="cpu")
    xt = torch.as_tensor(x)
    assert torch.equal(spmv_sliced(ell_to_sliced(A), xt), spmv_ell(A, xt))


@pytest.mark.parametrize("case", ["square_n_cols_sentinel",
                                  "square_ordered_sentinel", "empty_slices"])
def test_sliced_diagonal_matches_extract_diagonal(case):
    cols, vals, x = _case(case)
    n = cols.shape[0]
    cols[np.arange(n) % 2 == 0, 0] = np.arange(n)[np.arange(n) % 2 == 0]
    A = interop.ell_from_numpy(cols, vals, len(x), dtype=torch.float64,
                               device="cpu")
    assert torch.equal(sliced_diagonal(ell_to_sliced(A)), extract_diagonal(A))


def test_ell_spmv_on_the_cpu_takes_spmv_sliced_without_a_launch():
    cols, vals, x = _case("rectangular_ordered_sentinel")
    S = _sliced(cols, vals, len(x))
    before = ell_spmv_cuda.kernel.launches
    y = ell_spmv(S, torch.as_tensor(x))
    assert torch.equal(y, spmv_sliced(S, torch.as_tensor(x)))
    assert ell_spmv_cuda.kernel.launches == before
    with pytest.raises(TypeError, match="slice_ell"):
        ell_spmv(unslice(S), torch.as_tensor(x))


def _ordered_system(n):
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(1).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    dofmap = build_dofmap(mesh, 1, dbc)
    asm = build_reduced_assembler(
        mesh, 1, dofmap,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        torch.float64, "cpu")
    A0, b = asm(torch.as_tensor(to_element_minor(mesh.elem_coords())))
    ordering = build_ell_ordering(asm.pattern,
                                  mesh.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, "cpu",
                                  hybrid=True)
    return asm.pattern, ordering, A0, b


def test_one_gather_pack_of_an_ordering_equals_slicing_the_ordered_values():
    """EllOrdering.system packs the sliced values straight from the
    assembly's (N, K) values; gathering them into the ordered (N, K) form
    first and slicing that gives the same block."""
    pattern, ordering, A0, b = _ordered_system(7)
    S, bo = ordering.system(A0, b)
    cols, src, _ = permuted_sorted_cols(pattern.ell_cols, pattern.n_rows,
                                        ordering.order.numpy(),
                                        pattern.n_rows)
    ordered = A0.vals.reshape(-1)[torch.as_tensor(src.reshape(-1))]
    ref = slice_ell(torch.as_tensor(cols), pattern.n_rows).pack(ordered)
    assert torch.equal(S.cols, ref.cols) and torch.equal(S.vals, ref.vals)
    assert torch.equal(S.slice_ptr, ref.slice_ptr)
    # the TPU's padding (K = 16) is gone: the widest slice is the longest row
    assert S.max_width == np.diff(pattern.indptr).max() < pattern.ell_k
    assert torch.equal(bo, b[ordering.order])


def test_one_gather_pack_of_the_hybrid_remainder():
    """The hybrid remainder's sliced sources, composed once with the plan's
    rem_src, pack the values as slicing the plan's (N, K_rem) remainder
    does; the hybrid product is the ordered ELL product."""
    coords, conn, dbc = scrambled_delaunay(6, seed=3)
    mesh = interop.mesh_from_numpy("tetra4", coords, conn)
    dofmap = build_dofmap(mesh, 1, dbc)
    asm = build_reduced_assembler(
        mesh, 1, dofmap,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        torch.float64, "cpu")
    A0, b = asm(torch.as_tensor(to_element_minor(mesh.elem_coords())))
    ordering = build_ell_ordering(asm.pattern,
                                  mesh.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, "cpu",
                                  hybrid=True)
    H = ordering.hybrid.pack(A0.vals)
    assert H.rem is not None and H.dia is not None
    cols, src, _ = permuted_sorted_cols(asm.pattern.ell_cols,
                                        asm.pattern.n_rows,
                                        ordering.order.numpy(),
                                        asm.pattern.n_rows)
    plan = hybrid.split_sorted(cols, src, asm.pattern.n_rows)
    flat = A0.vals.reshape(-1).numpy()
    rem_vals = np.where(plan.rem_src >= 0,
                        flat[np.clip(plan.rem_src, 0, None)], 0.0)
    ref = _sliced(plan.rem_cols, rem_vals, asm.pattern.n_rows)
    assert torch.equal(H.rem.cols, ref.cols)
    assert torch.equal(H.rem.vals, ref.vals)
    assert H.rem.n_slots == sliced_slots(plan.rem_cols, plan.n_rows)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        asm.pattern.n_rows))
    S, _ = ordering.system(A0, b)
    y = hybrid.apply_hybrid(H, x)
    ref_y = spmv_sliced(S, x)
    assert (y - ref_y).abs().max() <= RTOL * ref_y.abs().max()
    assert torch.equal(H.diagonal(), sliced_diagonal(S))


def test_plan_bytes_count_the_sliced_remainder():
    cols, _, _ = _case("square_n_cols_sentinel")
    plan = hybrid.build_hybrid_plan(cols, cols.shape[0], fill_threshold=0.9)
    assert plan.D == 0 and plan.rem_cols is not None
    assert hybrid.plan_bytes(plan, 4) == \
        sliced_slots(plan.rem_cols, plan.n_rows) * 8
    assert sliced_slots(plan.rem_cols, plan.n_rows) <= \
        -(-plan.n_rows // SLICE) * SLICE * plan.k_rem


def test_routed_ell_block_reads_no_padded_slot():
    """An AMG tentative prolongator (one nonzero a row in K = 8 slots, the
    TPU's padding) is routed to B2 as a sliced block one slot wide."""
    rng = np.random.default_rng(5)
    n, n_cols = 4000, 500
    cols = np.full((n, 8), n_cols)
    cols[:, 0] = np.sort(rng.integers(0, n_cols, n))
    vals = np.where(cols < n_cols, rng.standard_normal(cols.shape), 0.0)
    d = build_device_ell(cols, vals, n_cols, dtype=torch.float64,
                         device="cpu")
    assert d.kind == "ell"
    assert d.ell.max_width == 1 and d.ell.n_slots == -(-n // SLICE) * SLICE
    x = torch.as_tensor(rng.standard_normal(n_cols))
    E = interop.ell_from_numpy(cols, vals, n_cols, dtype=torch.float64,
                               device="cpu")
    assert torch.equal(ell_spmv(d.ell, x), spmv_ell(E, x))
