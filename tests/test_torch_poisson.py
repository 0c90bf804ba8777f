"""Port parity: `solve_poisson` end to end, the package's public surface,
its options, and its independence from JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pfemfort_tpu as ft
import pfemfort_tpu_torch as pt
from pfemfort_tpu_torch import interop

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _meshes(dims, extent=(1.0, 1.0, 1.0)):
    nex, ney, nez = dims
    args = (0.0, extent[0], nex, 0.0, extent[1], ney, 0.0, extent[2], nez)
    jm, jd = ft.generate.box_tet(*args)
    tm, td = pt.generate.box_tet(*args)
    return (jm, jd), (tm, td)


@pytest.mark.parametrize("dims,extent", [((4, 4, 4), (1, 1, 1)),
                                         ((6, 6, 6), (1, 1, 1)),
                                         ((10, 10, 10), (1, 1, 1)),
                                         ((5, 7, 6), (1, 2, 0.5))])
def test_solve_poisson_matches_jax_and_is_nodally_exact(dims, extent):
    (jm, jd), (tm, td) = _meshes(dims, extent)
    rj = ft.solve_poisson(jm, jd, rtol=1e-11)
    rt = pt.solve_poisson(tm, td, rtol=1e-11, device="cpu",
                          dtype=torch.float64)
    assert rt.stats.iters == int(rj.stats.iters)
    assert rt.stats.converged and bool(rj.stats.converged)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10
    u_exact = (tm.coords ** 2).sum(axis=1)
    assert np.abs(rt.u_full - u_exact).max() < 1e-9
    assert rt.u_reduced.dtype == torch.float64
    assert rt.u_reduced.device.type == "cpu"
    assert set(rt.timings) == {"pattern_s", "assemble_s", "solve_s",
                               "pattern.dofmap_s", "pattern.coords_s",
                               "krylov.loop_s", "krylov.wait_s",
                               "krylov.host_reads"}


def test_solve_poisson_callable_source_kappa_matches_jax():
    (jm, jd), (tm, td) = _meshes((5, 5, 5))
    src = lambda xg: -6.0 + xg[:, 0] * xg[:, 1]
    kw = dict(source=src, kappa=(1.0, 2.0, 0.5), rtol=1e-11)
    rj = ft.solve_poisson(jm, jd, **kw)
    rt = pt.solve_poisson(tm, td, dtype=torch.float64, **kw, device="cpu")
    assert rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10


def test_solve_poisson_default_dtype_and_float32():
    (jm, jd), (tm, td) = _meshes((8, 8, 8))
    r = pt.solve_poisson(tm, td, rtol=1e-6, device="cpu")
    assert r.u_reduced.dtype == torch.get_default_dtype()
    r32 = pt.solve_poisson(tm, td, rtol=1e-6, dtype=torch.float32,
                           device="cpu")
    assert r32.u_reduced.dtype == torch.float32
    assert r32.stats.converged and r32.stats.relres <= 1e-6
    u_exact = (tm.coords ** 2).sum(axis=1)
    assert np.abs(r32.u_full - u_exact).max() < 1e-4
    rj = ft.solve_poisson(jm, jd, rtol=1e-6, dtype=np.float32)
    assert abs(r32.stats.iters - int(rj.stats.iters)) <= 2


def test_interop_mesh_from_numpy_solves_like_the_generator():
    (jm, jd), (tm, td) = _meshes((4, 5, 6))
    m2 = interop.mesh_from_numpy(jm.etype, jm.coords, jm.conn, jm.structure)
    r1 = pt.solve_poisson(tm, td, dtype=torch.float64, rtol=1e-10,
                          device="cpu")
    r2 = pt.solve_poisson(m2, jd, dtype=torch.float64, rtol=1e-10,
                          device="cpu")
    assert r1.stats == r2.stats
    np.testing.assert_array_equal(r1.u_full, r2.u_full)


@pytest.mark.parametrize("option", [
    dict(precond="ic0"), dict(precond="mg"), dict(precond="cheby"),
    dict(precond="amg"), dict(refine=True), dict(bc_mode="full"),
    dict(matrix_free=True)])
def test_options_outside_the_slice_raise(option):
    """The options once outside the port, all ported since (matrix_free
    last), give the JAX package's iterations and solution (precond 'mg' in
    reduced mode and 'amg' on a system too small to coarsen run Jacobi in
    both packages)."""
    (jm, jd), (tm, td) = _meshes((4, 4, 4))
    rj = ft.solve_poisson(jm, jd, rtol=1e-10, **option)
    rt = pt.solve_poisson(tm, td, rtol=1e-10, dtype=torch.float64, **option,
                          device="cpu")
    assert rt.stats.converged and bool(rj.stats.converged)
    assert rt.stats.iters == int(rj.stats.iters)
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10


@pytest.mark.parametrize("mesh_kind", ["no_structure", "partial_dirichlet"])
def test_meshes_outside_the_slice_raise(mesh_kind):
    """The meshes the structured slice could not take (no generator
    structure; a free set that is not a box) no longer raise: they take
    the pattern assembly (a DIA pattern without a lattice) and must solve
    as the JAX package does."""
    (jm, jd), (tm, td) = _meshes((4, 4, 4))
    if mesh_kind == "no_structure":
        tm = interop.mesh_from_numpy(tm.etype, tm.coords, tm.conn)
        jm = ft.Mesh(jm.etype, jm.coords, jm.conn)
    else:
        td, jd = td[td[:, 2] > 0.5], jd[jd[:, 2] > 0.5]
    rj = ft.solve_poisson(jm, jd, rtol=1e-11)
    rt = pt.solve_poisson(tm, td, rtol=1e-11, dtype=torch.float64,
                          device="cpu")
    assert rt.stats.iters == int(rj.stats.iters)
    assert rt.stats.converged
    assert np.abs(rt.u_full - rj.u_full).max() < 1e-10


def test_public_surface():
    for name in ("generate", "build_dofmap", "solve_poisson", "cg_solve",
                 "SolveStats", "solve_elasticity", "explicit_dynamics",
                 "bicgstab_solve", "gmres_solve"):
        assert hasattr(pt, name)


def test_import_leaves_jax_out_of_a_fresh_process():
    code = ("import sys, pfemfort_tpu_torch, pfemfort_tpu_torch.interop, "
            "pfemfort_tpu_torch.sparse.ops, pfemfort_tpu_torch.drivers.cli, "
            "pfemfort_tpu_torch.io.vtk, pfemfort_tpu_torch.config, "
            "pfemfort_tpu_torch.dynamics.checkpoint; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'pfemfort_tpu.')) "
            "or m == 'pfemfort_tpu'); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"


def test_port_sources_name_no_jax_module():
    for path in (REPO / "pfemfort_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "pfemfort_tpu"), \
                    f"{path}: {line}"


def _entry_calls():
    """Each public entry point, called on a tiny problem with its default
    device."""
    from pfemfort_tpu_torch.cfd import fractional_step_ns
    from pfemfort_tpu_torch.drivers.common import solve_implicit, \
        solve_implicit_fullsystem
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
    from pfemfort_tpu_torch.solve.highprec import solve_box_poisson_1e8

    box, dbc = pt.generate.box_tet(0, 1, 2, 0, 1, 2, 0, 1, 2)
    clamp = np.array([[n, c, 0.0] for n in dbc[:, 0] for c in range(3)])
    tri = pt.generate.rect_tria(0, 1, 2, 0, 1, 2)
    fixed = np.array([[0, 0, 0.0], [0, 1, 0.0]])
    fn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    return {
        "solve_poisson": (pt.solve_poisson, lambda f: f(box, dbc)),
        "solve_elasticity": (pt.solve_elasticity,
                             lambda f: f(box, clamp, 1.0, 0.3)),
        "solve_implicit": (solve_implicit, lambda f: f(box, 1, dbc, fn)),
        "solve_implicit_fullsystem": (solve_implicit_fullsystem,
                                      lambda f: f(box, 1, dbc, fn)),
        "explicit_dynamics": (pt.explicit_dynamics, lambda f: f(
            tri, fixed, 1.0, 0.3, 1.0, 1e-3, 1)),
        "solve_box_poisson_1e8": (solve_box_poisson_1e8,
                                  lambda f: f(box, dbc)),
        "fractional_step_ns": (fractional_step_ns, lambda f: f(
            tri, fixed, nu_visc=0.05, dt=1e-3, nsteps=1)),
    }


@pytest.mark.parametrize("entry", ["solve_poisson", "solve_elasticity",
                                   "solve_implicit",
                                   "solve_implicit_fullsystem",
                                   "explicit_dynamics",
                                   "solve_box_poisson_1e8",
                                   "fractional_step_ns"])
def test_entry_points_default_to_the_card(entry):
    """Every public entry point runs on the card unless the caller asks
    for the CPU: its device defaults to 'cuda', and without a card it
    raises, naming device='cpu', instead of carrying on on the CPU."""
    import inspect

    fn, call = _entry_calls()[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(fn)
