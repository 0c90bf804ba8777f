"""Port parity: the ELL format, its plain SpMV and the kernel B2 wrapper.

The port's plain `spmv_ell` (the JAX-parity oracle of the padded form) and
`extract_diagonal` are held against JAX `spmv_ell` and `extract_diagonal`,
and against the slot-gather plan run by `apply_slotgather_reference`, which
is how the JAX package's own tests run kernel B2 on the CPU
(tests/test_slotgather.py).  Cases: square and rectangular blocks, with the
pattern builder's sentinel (n_cols) and the row ordering's (2 * n_rows +
128).  The kernel's wrapper takes the sliced layout
(tests/test_torch_sliced_ell.py); the kernel itself runs only on the card:
tests/test_torch_cuda.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfemfort_tpu.sparse import spmv as jspmv
from pfemfort_tpu.sparse.formats import ELLMatrix as JELL
from pfemfort_tpu.sparse.ops import operator_and_diag as j_operator_and_diag
from pfemfort_tpu.sparse.slotgather import apply_slotgather_reference, \
    build_slotgather_plan
from pfemfort_tpu_torch import cuda_build, interop
from pfemfort_tpu_torch.sparse import dia_spmv_cuda, ell_spmv_cuda, \
    spmv as tspmv
from pfemfort_tpu_torch.sparse.ell_spmv_cuda import ell_spmv
from pfemfort_tpu_torch.sparse.ops import operator_and_diag
from pfemfort_tpu_torch.sparse.sliced import SlicedELL, ell_to_sliced

torch.set_num_threads(1)

# Same products in float64; the sums over K slots may run in another order.
RTOL = 1e-12


def _random_ell(n_rows, n_cols, k, sentinel, seed):
    """Ragged random ELL: each row keeps a random number of distinct valid
    columns, sorted, then sentinel slots with zero values.  The diagonal
    is kept where it exists so that extract_diagonal has work to do."""
    rng = np.random.default_rng(seed)
    cols = np.empty((n_rows, k), np.int64)
    vals = rng.standard_normal((n_rows, k))
    for r in range(n_rows):
        deg = int(rng.integers(1, k + 1))
        pick = rng.choice(n_cols, size=deg, replace=False)
        if r < n_cols and r not in pick:
            pick[0] = r
        cols[r] = np.concatenate([np.sort(pick), np.full(k - deg, sentinel)])
        vals[r, deg:] = 0.0
    return cols, vals, rng.standard_normal(n_cols)


CASES = {
    "square_n_cols_sentinel": (300, 300, 7, "n_cols"),
    "square_ordered_sentinel": (300, 300, 7, "ordered"),
    "rectangular_n_cols_sentinel": (257, 400, 5, "n_cols"),
    "rectangular_ordered_sentinel": (257, 400, 9, "ordered"),
}


def _case(name):
    n_rows, n_cols, k, kind = CASES[name]
    sentinel = n_cols if kind == "n_cols" else 2 * n_rows + 128
    return _random_ell(n_rows, n_cols, k, sentinel, seed=len(name))


def _close(y, ref):
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(y - ref).max() <= RTOL * scale


@pytest.mark.parametrize("case", list(CASES))
def test_spmv_ell_matches_jax_and_the_slotgather_reference(case):
    cols, vals, x = _case(case)
    n_rows, n_cols = cols.shape[0], len(x)
    Aj = JELL(cols=jnp.asarray(cols.astype(np.int32)), vals=jnp.asarray(vals),
              n_cols=n_cols)
    y_jax = np.asarray(jspmv.spmv_ell(Aj, jnp.asarray(x)))
    plan = build_slotgather_plan(cols, n_rows, n_cols=n_cols)
    valsv = np.where(plan.src >= 0,
                     vals.reshape(-1)[np.clip(plan.src, 0, None)], 0.0)
    y_sg = apply_slotgather_reference(plan, valsv, x)
    At = interop.ell_from_numpy(cols, vals, n_cols, dtype=torch.float64,
                                device="cpu")
    y = tspmv.spmv_ell(At, torch.as_tensor(x)).numpy()
    _close(y, y_jax)
    _close(y, y_sg)
    valid = cols < n_cols
    ref = (np.where(valid, vals, 0.0)
           * x[np.where(valid, cols, 0)]).sum(axis=1)
    _close(y, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_extract_diagonal_matches_jax(case):
    cols, vals, x = _case(case)
    Aj = JELL(cols=jnp.asarray(cols.astype(np.int32)), vals=jnp.asarray(vals),
              n_cols=len(x))
    At = interop.ell_from_numpy(cols, vals, len(x), dtype=torch.float64,
                                device="cpu")
    np.testing.assert_array_equal(tspmv.extract_diagonal(At).numpy(),
                                  np.asarray(jspmv.extract_diagonal(Aj)))


def test_operator_and_diag_on_cpu_takes_the_plain_version():
    cols, vals, x = _case("square_n_cols_sentinel")
    Aj = JELL(cols=jnp.asarray(cols.astype(np.int32)), vals=jnp.asarray(vals),
              n_cols=len(x))
    At = interop.ell_from_numpy(cols, vals, len(x), dtype=torch.float64,
                                device="cpu")
    op_j, diag_j = j_operator_and_diag(Aj)
    before = ell_spmv_cuda.kernel.launches
    op_t, diag_t = operator_and_diag(At)
    y = op_t(torch.as_tensor(x))
    assert ell_spmv_cuda.kernel.launches == before
    _close(y.numpy(), np.asarray(op_j(jnp.asarray(x))))
    np.testing.assert_array_equal(diag_t.numpy(), np.asarray(diag_j))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_ell_spmv_rejects_other_dtypes(dtype):
    A = ell_to_sliced(interop.ell_from_numpy(
        np.zeros((4, 2), np.int64), np.ones((4, 2)), 4, dtype=dtype,
        device="cpu"))
    with pytest.raises(TypeError):
        ell_spmv(A, torch.ones(4, dtype=dtype))


def test_ell_spmv_rejects_wrong_shapes_mixed_dtypes_and_other_devices():
    cols = np.array([[0, 1], [1, 4], [2, 4], [3, 4]])
    E = interop.ell_from_numpy(cols, np.ones((4, 2)), 4, dtype=torch.float32,
                               device="cpu")
    A = ell_to_sliced(E)
    with pytest.raises(TypeError):
        ell_spmv(A, torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        ell_spmv(A, torch.ones(5, dtype=torch.float32))
    with pytest.raises(TypeError, match="slice_ell"):
        ell_spmv(E, torch.ones(4, dtype=torch.float32))
    Am = SlicedELL(cols=A.cols.to("meta"), vals=A.vals.to("meta"),
                   slice_ptr=A.slice_ptr.to("meta"), n_rows=4, n_cols=4,
                   max_width=A.max_width)
    with pytest.raises(ValueError, match="no kernel"):
        ell_spmv(Am, torch.ones(4, dtype=torch.float32, device="meta"))


def test_interop_ell_rejects_bad_input():
    with pytest.raises(ValueError):
        interop.ell_from_numpy(np.zeros((3, 2)), np.zeros((3, 3)), 3,
                               device="cpu")
    with pytest.raises(ValueError):
        interop.ell_from_numpy(-np.ones((3, 2)), np.zeros((3, 2)), 3,
                               device="cpu")


def test_ell_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        ell_spmv_cuda.kernel.build()


def test_ell_kernel_builds_for_sm90a_into_an_ignored_directory():
    root = Path(cuda_build.__file__).resolve().parents[1]
    kern = ell_spmv_cuda.kernel
    assert kern.source == root / "pfemfort_tpu_torch/csrc/ell_spmv.cu"
    assert kern.source.exists()
    assert kern.library_path().parent == cuda_build.BUILD_DIR
    assert kern.library_path() != dia_spmv_cuda.kernel.library_path()
