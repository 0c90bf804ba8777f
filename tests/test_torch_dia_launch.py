"""The host side of kernel B1's launch (sparse/dia_spmv_cuda.py:launch_plan):
which rows each block owns, which blocks read x with no bounds test, the
grid and the packed offsets.  Pure Python: it runs without a card, and a
plan that covered a row twice, missed one, or called a block interior
whose reads leave [0, n) would be caught here.
"""

import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pfemfort_tpu_torch.sparse import dia_spmv_cuda as b1
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia, \
    spmv_dia_halo_local

T = b1.THREADS


def _rows(plan):
    """(grid, THREADS) rows of each block, -1 past n."""
    rows = np.arange(plan.grid)[:, None] * T + np.arange(T)[None, :]
    return np.where(rows < plan.n, rows, -1)


def _check_plan(offsets, n):
    plan = b1.launch_plan(tuple(offsets), n)
    D = len(offsets)
    rows = _rows(plan)
    owned = rows[rows >= 0]
    # every row is covered exactly once
    assert len(owned) == n
    assert np.array_equal(np.sort(owned), np.arange(n))
    # the interior rows [lo, hi) are those whose every read lies in [0, n)
    lo = max(0, -min(offsets, default=0))
    hi = n - max(0, max(offsets, default=0))
    assert (plan.lo, plan.hi) == (lo, hi)
    offs = np.asarray(offsets, dtype=np.int64)
    for b in range(plan.grid):
        r = rows[b]
        interior = plan.interior_begin <= b < plan.interior_end
        inside = bool((r >= lo).all() and (r < hi).all())
        # a block is interior exactly when all its rows are interior rows
        assert interior == inside, (b, plan)
        if interior and D:
            reads = r[:, None] + offs[None, :]
            assert reads.min() >= 0 and reads.max() < n
    assert 0 <= plan.interior_begin <= plan.interior_end <= plan.grid \
        or plan.interior_begin == plan.interior_end
    # the offsets, in the caller's order, then zeros
    assert plan.n_diag == D and len(plan.packed) == b1.MAX_DIAGONALS
    assert plan.packed[:D] == tuple(offsets)
    assert not any(plan.packed[D:])
    assert plan.grid == -(-n // T) <= 2 ** 31 - 1
    return plan


@pytest.mark.parametrize("offsets, n", [
    ((3, -1, 0, 12, -7), 5_000),                  # unsorted
    ((-(1_000 + 5), -3, 0, 2, 1_000 + 2), 1_000),  # reaching past +-n
    ((-600, 0, 600), 1_000),                      # empty interior
    ((-40, -1, 0, 1, 40), 40),                    # w = P
    ((0,), 1),                                    # D = 1, a single row
    ((-2,), 3),
    (tuple(range(-64, 64)), 300_007),             # D = MAX_DIAGONALS
    ((-1, 0, 1), 100),                            # n below one block
    ((-9, 0, 1, 9), 3 * T + 17),                  # n not a multiple of T
    ((-9_216, -96, -1, 0, 1, 96, 9_216), 1_000_003),
    ((), 777),                                    # no diagonal
])
def test_plan_covers_every_row_once_and_its_interior_reads_stay_inside(
        offsets, n):
    _check_plan(offsets, n)


def _lattice_offsets(L):
    """The 15 offsets of the 6-tet box_tet stencil on an L^3 lattice."""
    up = [(0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0),
          (1, 1, 1)]
    flat = [a * L * L + b * L + c for a, b, c in up]
    return tuple(sorted([0] + flat + [-o for o in flat]))


@pytest.mark.parametrize("L, n", [(95, 95 ** 3), (13, 13 ** 3),
                                  (199, 990_025), (95, 866_400)])
def test_plan_on_the_lattice_shapes_of_the_solves(L, n):
    """The n=96 lattice, the 13^3 multigrid level, rank 1 of the n=200
    slab and the world-size-1 block of whole planes: at most the blocks
    within one plane of either end are edge blocks."""
    plan = _check_plan(_lattice_offsets(L), n)
    edge = plan.grid - (plan.interior_end - plan.interior_begin)
    assert edge <= 2 * (-(-(L * L + L + 1) // T)) + 2


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 70_000),
       offsets=st.lists(st.integers(-80_000, 80_000), min_size=0,
                        max_size=b1.MAX_DIAGONALS, unique=True))
def test_plan_on_random_offset_sets(n, offsets):
    _check_plan(offsets, n)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(130_000, 600_000),
       reach=st.integers(0, 40_000), d=st.integers(1, 60))
def test_plan_at_solve_sizes(n, reach, d):
    """Sizes and halo widths of the port's solves (a rank's rows, a
    lattice's plane or an elasticity census's reach)."""
    offsets = tuple(np.random.default_rng(n).integers(
        -reach, reach + 1, d).tolist())
    _check_plan(tuple(dict.fromkeys(offsets)), n)


def test_more_than_max_diagonals_raise_naming_the_count():
    offsets = tuple(range(b1.MAX_DIAGONALS + 1))
    with pytest.raises(ValueError, match=str(b1.MAX_DIAGONALS + 1)):
        b1.launch_plan(offsets, 1_000)


def test_cap_is_the_dia_census_cap():
    """Every DIA system the port builds fits: the pattern census and the
    preconditioners' routing take the DIA form up to 128 diagonals."""
    import inspect

    from pfemfort_tpu_torch.assembly.pattern import build_pattern
    from pfemfort_tpu_torch.solve.amg_device import DIA_MAX_OFFSETS

    cap = inspect.signature(build_pattern).parameters["max_offsets"].default
    assert b1.MAX_DIAGONALS == cap == DIA_MAX_OFFSETS


def test_c_plan_is_the_kernel_struct():
    """The ctypes struct mirrors csrc/dia_spmv.cu:LaunchPlan (4 int64, 1 +
    MAX_DIAGONALS int32) and carries the plan's fields."""
    plan = b1.launch_plan((5, -3, 0), 999_999)
    c = b1.CPlan.of(plan)
    size = 4 * 8 + 4 * (1 + b1.MAX_DIAGONALS)
    assert ctypes.sizeof(b1.CPlan) == -(-size // 8) * 8
    assert (c.n, c.grid, c.interior_begin, c.interior_end, c.n_diag) == (
        plan.n, plan.grid, plan.interior_begin, plan.interior_end,
        plan.n_diag)
    assert tuple(c.offsets) == plan.packed


@pytest.mark.parametrize("halos", [False, True])
def test_cpu_tensors_take_the_plain_version_beyond_the_cap(halos):
    """The cap is the kernel's: on the CPU the wrappers are the plain
    versions at any number of diagonals, and launch nothing."""
    rng = np.random.default_rng(2)
    offsets = tuple(range(-70, 70))
    n = 150
    A = DIAMatrix(vals=torch.as_tensor(rng.standard_normal((len(offsets),
                                                            n))),
                  offsets=offsets, n_rows=n)
    x = torch.as_tensor(rng.standard_normal(n))
    before = b1.kernel.launches
    if halos:
        y = b1.dia_spmv_halo(A, x, None, None)
        assert torch.equal(y, spmv_dia_halo_local(A, x, None, None))
    else:
        assert torch.equal(b1.dia_spmv(A, x), spmv_dia(A, x))
    assert b1.kernel.launches == before
