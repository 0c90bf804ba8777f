"""The float32 nodal-error floor of the box_tet Poisson solve is the same in
both packages.

box_tet n=48, Jacobi-CG to rtol 1e-8 in float32: the solve has reached its
round-off floor (the error no longer falls with rtol), and the port's and
the JAX package's nodal errors against u = x^2+y^2+z^2 lie within 1.25x of
each other.  Their float32 reduced systems are rounded alike: the largest
error of A's values and of b against each package's float64 system is the
same.  This grounds the bench's `large` nodal bar
(pfemfort_tpu_torch/bench.py:NODAL) on the JAX package's float32 floor.
"""

import numpy as np
import torch

N, RTOL, FLOOR_RATIO = 48, 1e-8, 1.25


def _port_system(mesh, dbc, dtype):
    from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
    from pfemfort_tpu_torch.drivers.common import build_reduced_assembler
    from pfemfort_tpu_torch.elements.geometry import to_element_minor
    from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices

    assemble = build_reduced_assembler(
        mesh, 1, build_dofmap(mesh, 1, dbc, with_elem=False),
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0), dtype,
        "cpu")
    A, b = assemble(torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                    dtype=dtype))
    return A.vals.double().numpy(), b.double().numpy()


def _jax_system(mesh, dbc, dtype):
    import jax.numpy as jnp
    from pfemfort_tpu.dofs.dofmap import build_dofmap
    from pfemfort_tpu.drivers.common import build_reduced_assembler
    from pfemfort_tpu.elements.geometry import to_element_minor
    from pfemfort_tpu.elements.poisson import poisson_element_matrices

    assemble, _ = build_reduced_assembler(
        mesh, 1, build_dofmap(mesh, 1, dbc, with_elem=False),
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0), dtype)
    A, b = assemble(jnp.asarray(to_element_minor(mesh.elem_coords()),
                                dtype=dtype))
    return (np.asarray(A.vals, dtype=np.float64),
            np.asarray(b, dtype=np.float64))


def test_float32_nodal_floors_agree_with_jax():
    import jax.numpy as jnp
    import pfemfort_tpu as ft
    import pfemfort_tpu_torch as pt

    mesh, dbc = pt.generate.box_tet(0, 1, N, 0, 1, N, 0, 1, N)
    jmesh, jdbc = ft.mesh.generate.box_tet(0, 1, N, 0, 1, N, 0, 1, N)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    port = pt.solve_poisson(mesh, dbc, dtype=torch.float32, rtol=RTOL,
                            device="cpu")
    ref = ft.solve_poisson(jmesh, jdbc, dtype=jnp.float32, rtol=RTOL)
    assert port.stats.converged and bool(np.asarray(ref.stats.converged))
    e_port = float(np.abs(port.u_full - u_exact).max())
    e_jax = float(np.abs(np.asarray(ref.u_full) - u_exact).max())
    assert max(e_port, e_jax) <= FLOOR_RATIO * min(e_port, e_jax), \
        (e_port, e_jax)

    err = {name: tuple(np.abs(lo - hi).max() for lo, hi in zip(
        system(m, d, dts[0]), system(m, d, dts[1])))
        for name, system, m, d, dts in (
            ("port", _port_system, mesh, dbc, (torch.float32, torch.float64)),
            ("jax", _jax_system, jmesh, jdbc, (jnp.float32, jnp.float64)))}
    np.testing.assert_allclose(err["port"], err["jax"], rtol=1e-6)
