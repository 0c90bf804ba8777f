"""The port's CUDA kernel against its plain PyTorch version, on the card.

Marked `cuda`: each test skips without a CUDA device.  This file imports no
JAX, so it runs where JAX is not installed:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch import generate, solve_poisson
from pfemfort_tpu_torch.sparse import dia_spmv_cuda
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, spmv_dia
from pfemfort_tpu_torch.sparse.ops import dia_operator

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
