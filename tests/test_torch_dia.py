"""Port parity: the DIA format, its plain SpMV and the operator wrapper.

The port's plain `spmv_dia` (the CPU path and the CUDA kernel's oracle) is
held against JAX `spmv_dia` and against the Pallas kernel in interpret mode,
`spmv_dia_pallas(..., interpret=True)`, on the three shapes of
tests/test_pallas_spmv.py, through both the flat and the lattice branch.
The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.assembly.assemble import assemble_matrix
from pfemfort_tpu.assembly.pattern import build_pattern
from pfemfort_tpu.dofs.dofmap import build_dofmap, reduced_lattice
from pfemfort_tpu.elements.geometry import to_element_minor
from pfemfort_tpu.elements.poisson import poisson_element_matrices
from pfemfort_tpu.mesh import generate
from pfemfort_tpu.sparse import dia as jdia
from pfemfort_tpu.sparse.ops import operator_and_diag as j_operator_and_diag
from pfemfort_tpu.sparse.pallas_spmv import spmv_dia_pallas
from pfemfort_tpu_torch import cuda_build, interop
from pfemfort_tpu_torch.sparse import dia as tdia
from pfemfort_tpu_torch.sparse import dia_spmv_cuda
from pfemfort_tpu_torch.sparse.ops import dia_operator, operator_and_diag

torch.set_num_threads(1)

# Same products, summed in the same offset order in float64.
ATOL = 1e-12

# (lattice n, Pallas block options) of tests/test_pallas_spmv.py
SHAPES = {"single_block": (6, {}),
          "multi_block": (8, dict(block_rows=8)),
          "chunked": (10, dict(block_rows=8, vmem_x_rows=32))}


def _jax_dia(n, branch):
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc)
    lattice = reduced_lattice(mesh, dofmap) if branch == "lattice" else None
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof,
                            lattice=lattice)
    Ke, _ = poisson_element_matrices(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4")
    return assemble_matrix(Ke, pattern)


def _port(A):
    return interop.dia_from_numpy(np.asarray(A.vals), A.offsets, A.n_rows,
                                  A.lattice, device="cpu",
                                  dtype=torch.float64)


@pytest.mark.parametrize("branch", ["flat", "lattice"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_spmv_dia_matches_jax_and_pallas_interpret(shape, branch):
    n, block_opts = SHAPES[shape]
    A = _jax_dia(n, branch)
    assert (A.lattice is None) == (branch == "flat")
    if branch == "lattice":
        assert tdia.decompose_offsets(A.offsets, A.lattice) is not None
    x = np.random.default_rng(n).standard_normal(A.n_rows)
    y_jax = np.asarray(jdia.spmv_dia(A, jnp.asarray(x)))
    y_pallas = np.asarray(spmv_dia_pallas(A, jnp.asarray(x), interpret=True,
                                          **block_opts))
    y = tdia.spmv_dia(_port(A), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=ATOL)
    np.testing.assert_allclose(y, y_pallas, rtol=0, atol=ATOL)


def test_spmv_dia_ragged_offsets_past_both_ends():
    """Offsets whose reads fall off either end of x (they read zeros)."""
    rng = np.random.default_rng(3)
    n = 1001
    offsets = (-(n + 5), -37, -1, 0, 2, 500, n + 2)
    vals = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    Aj = jdia.DIAMatrix(vals=jnp.asarray(vals), offsets=offsets, n_rows=n)
    y_jax = np.asarray(jdia.spmv_dia(Aj, jnp.asarray(x)))
    At = interop.dia_from_numpy(vals, offsets, n, None, dtype=torch.float64,
                                device="cpu")
    y = tdia.spmv_dia(At, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=ATOL)
    ref = np.zeros(n)
    for d, o in enumerate(offsets):
        j = np.arange(n) + o
        ok = (j >= 0) & (j < n)
        ref[ok] += vals[d, ok] * x[j[ok]]
    np.testing.assert_allclose(y, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("offsets,shape", [
    ((-31, -6, -5, -1, 0, 1, 5, 6, 31), (5, 5, 5)),
    ((-1, 0, 1, 7), (3, 7)),
    ((0, 3), (4, 4)),
    ((-12, 0, 12), (4, 6)),
])
def test_decompose_offsets_matches(offsets, shape):
    assert (tdia.decompose_offsets(offsets, shape)
            == jdia.decompose_offsets(offsets, shape))


@pytest.mark.parametrize("offsets", [(-3, 0, 3), (-3, 3)])
def test_dia_diagonal_matches(offsets):
    vals = np.random.default_rng(4).standard_normal((len(offsets), 9))
    Aj = jdia.DIAMatrix(vals=jnp.asarray(vals), offsets=offsets, n_rows=9)
    At = interop.dia_from_numpy(vals, offsets, 9, None, dtype=torch.float64,
                                device="cpu")
    np.testing.assert_array_equal(tdia.dia_diagonal(At).numpy(),
                                  np.asarray(jdia.dia_diagonal(Aj)))


def test_operator_and_diag_on_cpu_takes_the_plain_version():
    A = _jax_dia(6, "lattice")
    At = _port(A)
    x = np.random.default_rng(5).standard_normal(A.n_rows)
    op_j, diag_j = j_operator_and_diag(A)
    before = dia_spmv_cuda.kernel.launches
    op_t, diag_t = operator_and_diag(At)
    y = op_t(torch.as_tensor(x))
    assert dia_spmv_cuda.kernel.launches == before
    np.testing.assert_allclose(y.numpy(), np.asarray(op_j(jnp.asarray(x))),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(diag_t.numpy(), np.asarray(diag_j))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_dia_operator_rejects_other_dtypes(dtype):
    A = interop.dia_from_numpy(np.ones((3, 8)), (-1, 0, 1), 8, None,
                               dtype=dtype, device="cpu")
    with pytest.raises(TypeError):
        dia_operator(A)(torch.ones(8, dtype=dtype))


def test_dia_operator_rejects_mixed_dtypes_and_other_devices():
    A = interop.dia_from_numpy(np.ones((3, 8)), (-1, 0, 1), 8, None,
                               dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError):
        dia_operator(A)(torch.ones(8, dtype=torch.float64))
    Am = interop.dia_from_numpy(np.ones((3, 8)), (-1, 0, 1), 8, None,
                                device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        dia_operator(Am)(torch.ones(8, dtype=torch.float32, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        dia_spmv_cuda.kernel.build()


def test_kernel_builds_for_sm90a_into_an_ignored_directory():
    root = Path(cuda_build.__file__).resolve().parents[1]
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert dia_spmv_cuda.kernel.source.exists()
    build_dir = cuda_build.BUILD_DIR.relative_to(root).as_posix()
    assert f"{build_dir}/" in (root / ".gitignore").read_text().split()
    assert dia_spmv_cuda.kernel.library_path().parent == cuda_build.BUILD_DIR


def test_interop_dia_rejects_mismatched_shape():
    with pytest.raises(ValueError):
        interop.dia_from_numpy(np.ones((2, 8)), (-1, 0, 1), 8, None,
                               device="cpu")
