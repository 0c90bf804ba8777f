"""Port parity: the host library's ELL pattern builder and mesh partitioners
(csrc/host_native.cpp) against the port's numpy builder and the JAX
package (its native library, which conftest builds).

The pattern arrays must be bit-identical: the assembly's summation order,
and so the bit-repeatability of every ELL solve on the card, is fixed by
mat_perm and mat_segids.  Partitions and edge cuts must be identical too.
"""

import numpy as np
import pytest

from pfemfort_tpu import native as jnative
from pfemfort_tpu.assembly.pattern import build_pattern as j_build_pattern
from pfemfort_tpu.dofs.dofmap import build_dofmap
from pfemfort_tpu.mesh import generate
from pfemfort_tpu.mesh.core import Mesh as JMesh
from pfemfort_tpu.parallel.partition import partition_elements as j_partition
from pfemfort_tpu_torch import host_native, interop
from pfemfort_tpu_torch.assembly import pattern as tpat
from pfemfort_tpu_torch.parallel.partition import edge_cut, \
    partition_elements
from test_torch_general import scrambled_delaunay

FIELDS = ("indptr", "indices", "ell_cols", "mat_perm", "mat_segids")


def _renumbered(mesh, dbc, seed=0):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _clamped(mesh):
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def _case(kind):
    """(JAX mesh, dirichlet, ndof) of one pattern case."""
    if kind.startswith("renumbered_box"):
        mesh, dbc = _renumbered(*generate.box_tet(0, 1, 6, 0, 1, 5, 0, 1, 7))
        ndof = 3 if kind.endswith("ndof3") else 1
        if ndof == 3:
            dbc = _clamped(mesh)
        return mesh, dbc, ndof
    if kind == "delaunay":
        coords, conn, dbc = scrambled_delaunay(6)
        return JMesh("tetra4", coords, conn), dbc, 1
    mesh = generate.rect_tria(0, 2, 14, 0, 1, 9)
    if kind == "rect_tria_ndof2":
        return mesh, _clamped(mesh), 2
    mesh, dbc = _renumbered(mesh, _clamped(mesh)[::2])
    return mesh, dbc, 1


@pytest.mark.parametrize("kind", ["renumbered_box", "renumbered_box_ndof3",
                                  "delaunay", "rect_tria_ndof2",
                                  "rect_tria_renumbered"])
def test_native_ell_pattern_matches_numpy_and_jax(kind):
    mesh, dbc, ndof = _case(kind)
    dm = build_dofmap(mesh, ndof, dbc)
    native = tpat.build_pattern(dm.elem_dof, dm.total_dof, layout="ell")
    numpy_ = tpat._ell_pattern_numpy(np.asarray(dm.elem_dof), dm.total_dof,
                                     8, native.rhs_dest)
    jax_ = j_build_pattern(dm.elem_dof, dm.total_dof, layout="ell")
    for other in (numpy_, jax_):
        assert (native.nnz, native.ell_k, native.mat_nsegs) == \
            (other.nnz, other.ell_k, other.mat_nsegs)
        for f in FIELDS:
            a, b = getattr(native, f), np.asarray(getattr(other, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_auto_layout_takes_the_native_builder_off_the_census():
    """A renumbered box fails the DIA census, so 'auto' builds ELL through
    the host library, with the JAX package's arrays."""
    mesh, dbc = _renumbered(*generate.box_tet(0, 1, 7, 0, 1, 7, 0, 1, 7))
    dm = build_dofmap(mesh, 1, dbc)
    t = tpat.build_pattern(dm.elem_dof, dm.total_dof)
    j = j_build_pattern(dm.elem_dof, dm.total_dof)
    assert t.layout == j.layout == "ell"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_native_builder_declines_int32_overflow():
    """Past int32 entry ids the library returns None and build_pattern
    takes the numpy builder (the JAX package's rule); checked on the
    binding's size test, without allocating such a pattern."""
    ed = np.lib.stride_tricks.as_strided(np.zeros(1, np.int32),
                                         shape=(2**27, 16), strides=(0, 0))
    assert host_native.ell_pattern(ed, 10) is None


def _meshes(kind):
    if kind == "box_tet":
        return generate.box_tet(0, 1, 6, 0, 2, 5, 0, 1, 4)[0]
    coords, conn, _ = scrambled_delaunay(7, seed=5)
    return JMesh("tetra4", coords, conn)


@pytest.mark.parametrize("kind", ["box_tet", "delaunay"])
@pytest.mark.parametrize("method", ["rcb", "greedy"])
@pytest.mark.parametrize("nparts", [4, 7])
def test_partitions_and_edge_cuts_match_jax(kind, method, nparts):
    jm = _meshes(kind)
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    pj = j_partition(jm, nparts, method=method)
    pt_ = partition_elements(tm, nparts, method=method)
    np.testing.assert_array_equal(pt_, pj)
    assert np.bincount(pt_, minlength=nparts).min() > 0
    cut_j = jnative.edge_cut(jm.conn, jm.n_node, 3, pj)
    assert edge_cut(tm, pt_) == cut_j > 0
    # a random balanced partition cuts far more (as the JAX quality test)
    rand = np.random.default_rng(1).permutation(np.arange(tm.n_elem)
                                                % nparts).astype(np.int32)
    assert edge_cut(tm, pt_) < 0.7 * edge_cut(tm, rand)


def test_partition_slab_and_single_part():
    jm = _meshes("box_tet")
    tm = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn)
    for n, method in ((1, "rcb"), (3, "slab")):
        np.testing.assert_array_equal(partition_elements(tm, n, method),
                                      j_partition(jm, n, method))


def test_timer_and_timed_match_jax(capsys):
    """utils/timing.py (a copy): a phase entered twice accumulates under
    its name, a CPU tensor's `block_on` needs no synchronise, and the
    report and the `timed` line keep the JAX package's layout."""
    import torch

    from pfemfort_tpu.utils import timing as jtiming
    from pfemfort_tpu_torch.utils import timing as ttiming

    timer = ttiming.Timer()
    for name in ("solve", "setup", "solve"):
        with timer.phase(name, block_on=torch.ones(3)):
            pass
    assert list(timer.phases) == ["solve", "setup"]
    jtimer = jtiming.Timer()
    jtimer.phases = dict(timer.phases)
    assert timer.report() == jtimer.report()
    for mod in (ttiming, jtiming):
        with mod.timed("step"):
            pass
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [" step", " step"]
    assert all(ln.endswith(" seconds") for ln in lines)
