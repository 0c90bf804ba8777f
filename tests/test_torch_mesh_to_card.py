"""How a mesh reaches the card: elements/geometry.py makes every element
coordinate tensor and dofs/loads.py every nodal-load vector.

Each is held bit for bit to the JAX package's expression or to the inline
expression it replaced, and a source scan finds each decision written only
in its owner.  The `cuda` case (the card's coordinates equal the CPU's)
skips without a card; on the card:

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_mesh_to_card.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.dofs.loads import nodal_loads, reduced_loads
from pfemfort_tpu_torch.drivers.sharded import _force_vector
from pfemfort_tpu_torch.elements.geometry import affine_box_bounds, \
    box_element_coords, element_coords, rank_element_coords
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.mesh.core import Mesh

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "pfemfort_tpu_torch"

# generator name -> arguments: every element type the port meshes, on
# bounds whose lattice coordinates round in float32
MESHES = {
    "rect_tria": (0.1, 0.7, 3, -0.3, 0.5, 2),
    "rect_quad": (0.1, 0.7, 3, -0.3, 0.5, 2),
    "rect_tria6": (0.1, 0.7, 3, -0.3, 0.5, 2),
    "box_tet": (0.1, 0.7, 2, -0.3, 0.5, 3, 0.0, 1.3, 2),
    "box_hexa": (0.1, 0.7, 2, -0.3, 0.5, 3, 0.0, 1.3, 2),
    "box_prism": (0.1, 0.7, 2, -0.3, 0.5, 3, 0.0, 1.3, 2),
}


def _mesh(gen, kind):
    m = getattr(gen, kind)(*MESHES[kind])
    return m[0] if isinstance(m, tuple) else m


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(MESHES))
def test_element_coords_are_the_jax_gather(kind, dtype):
    from pfemfort_tpu.elements.geometry import to_element_minor
    from pfemfort_tpu.mesh import generate as jgen

    want = to_element_minor(_mesh(jgen, kind).elem_coords())
    got = element_coords(_mesh(generate, kind), dtype, "cpu")
    assert got.dtype == dtype and got.device.type == "cpu"
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), want.astype(torch.empty((), dtype=dtype).numpy().dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_element_coords_equal_the_cpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = _mesh(generate, "box_prism")
    got = element_coords(mesh, dtype, "cuda")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), element_coords(mesh, dtype, "cpu"))


def _perturbed_box():
    mesh, _ = generate.box_tet(*MESHES["box_tet"])
    coords = mesh.coords.copy()
    coords[5, 1] += 1e-3
    return Mesh(mesh.etype, coords, mesh.conn, structure=mesh.structure)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_affine_box_is_made_on_the_device(dtype):
    from pfemfort_tpu.mesh import generate as jgen
    from pfemfort_tpu.solve.multigrid import _is_affine_box

    mesh, _ = generate.box_tet(*MESHES["box_tet"])
    bounds = affine_box_bounds(mesh)
    jmesh, _ = jgen.box_tet(*MESHES["box_tet"])
    assert bounds == _is_affine_box(jmesh)
    (x0, x1), (y0, y1), (z0, z1) = bounds
    nex, ney, nez = MESHES["box_tet"][2::3]
    want = generate.box_tet_coords_em_device(
        x0, x1, nex, y0, y1, ney, z0, z1, nez, dtype=dtype, device="cpu")
    assert torch.equal(box_element_coords(mesh, bounds, dtype, "cpu"), want)


def test_a_perturbed_box_falls_back_to_the_gather():
    from pfemfort_tpu.solve.multigrid import _is_affine_box

    mesh = _perturbed_box()
    assert affine_box_bounds(mesh) is None
    assert _is_affine_box(mesh) is None
    got = box_element_coords(mesh, affine_box_bounds(mesh), torch.float64,
                             "cpu")
    assert torch.equal(got, element_coords(mesh, torch.float64, "cpu"))


@pytest.mark.parametrize("els", [[7, 2, 11, 3], []], ids=["owner", "none"])
def test_rank_element_coords_are_the_inline_gather(els):
    mesh = _mesh(generate, "box_prism")
    els = np.asarray(els, dtype=np.int64)
    width = 6
    # the expression parallel/dist_assembly.py and dist_ell.py wrote inline
    want = np.empty((mesh.npe, mesh.ndim, width), dtype=np.float64)
    want[:] = mesh.coords[mesh.conn[0]][:, :, None]
    if len(els):
        want[:, :, :len(els)] = np.transpose(mesh.coords[mesh.conn[els]],
                                             (1, 2, 0))
    got = rank_element_coords(mesh, els, width)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()


def _loads_problem(gen=generate, build=build_dofmap):
    """A 2-dof rect_tria clamped on x = 0.1, with three loads on one free
    dof (their sum depends on their order) and one on a clamped dof."""
    mesh = gen.rect_tria(*MESHES["rect_tria"])
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0.1))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    fbc = np.array([[5.0, 1.0, 1e16], [5.0, 1.0, 1.0], [5.0, 1.0, -1e16],
                    [6.0, 0.0, 0.25], [float(left[1]), 0.0, 3.0]])
    return mesh, build(mesh, 2, dbc), fbc


def _jax_dofmap():
    from pfemfort_tpu.dofs.dofmap import build_dofmap as j_build
    from pfemfort_tpu.mesh import generate as jgen

    return _loads_problem(jgen, j_build)[1]


def test_reduced_loads_are_the_jax_point_loads():
    from pfemfort_tpu.drivers.common import _point_loads as j_point_loads

    jd = _jax_dofmap()
    _, td, fbc = _loads_problem()
    got = reduced_loads(td, fbc)
    want = j_point_loads(jd, fbc)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got[td.node_dof[5, 1]] == 0.0       # 1e16 + 1 rounds to 1e16
    assert reduced_loads(td, None).tobytes() == \
        j_point_loads(jd, None).tobytes()


def test_sharded_force_vector_is_the_jax_one():
    from pfemfort_tpu.drivers.sharded import _force_vector as j_force

    jd = _jax_dofmap()
    _, td, fbc = _loads_problem()
    n_pad = td.total_dof + 5
    eq_perm = np.random.default_rng(0).permutation(n_pad)[:td.total_dof]
    got = _force_vector(td, eq_perm, n_pad, fbc)
    want = j_force(jd, eq_perm, n_pad, fbc)
    assert got.tobytes() == want.tobytes()


def test_nodal_loads_are_the_inline_full_vector():
    mesh, _, fbc = _loads_problem()
    ndof = 2
    # the expression the full-system and explicit paths wrote inline
    want = np.zeros(mesh.n_node * ndof, dtype=np.float64)
    idx = fbc[:, 0].astype(np.int64) * ndof + fbc[:, 1].astype(np.int64)
    np.add.at(want, idx, fbc[:, 2])
    got = nodal_loads(fbc, mesh.n_node, ndof)
    assert got.tobytes() == want.tobytes()
    assert got[int(fbc[-1, 0]) * ndof] == 3.0   # kept on the clamped dof
    assert not nodal_loads(None, mesh.n_node, ndof).any()
    assert not nodal_loads(fbc[:0], mesh.n_node, ndof).any()


# decision -> (pattern, the files that may hold it); a `quoted` mention in
# a docstring is not a use
OWNERS = {
    "element_gather": (r"(?<!`)to_element_minor\(\s*\w+\.elem_coords\(\)",
                       {"elements/geometry.py"}),
    "box_on_device": (r"box_tet_coords_em_device",
                      {"elements/geometry.py", "mesh/generate.py"}),
    "rank_gather": (r"\bcoords\[(?:\w+\.)?conn(?:_t)?\[",
                    {"elements/geometry.py"}),
    "affine_check": (r"_is_affine_box|def affine_box_bounds",
                     {"elements/geometry.py"}),
    "nodal_loads": (r"np\.add\.at\([^)]*force_bc",
                    {"dofs/loads.py"}),
}


@pytest.mark.parametrize("decision", list(OWNERS))
def test_each_decision_lives_in_its_owner(decision):
    pattern, owners = OWNERS[decision]
    found = {p.relative_to(PACKAGE).as_posix()
             for p in PACKAGE.rglob("*.py")
             if re.search(pattern, p.read_text())}
    assert found <= owners, sorted(found - owners)
    assert found, "the owner no longer holds it"
