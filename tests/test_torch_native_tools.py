"""Port parity: the native host tooling (ROADMAP A.10b).

`host_native.gen_tet_mesh` (csrc/host_native.cpp:pfem_gen_tet_mesh) writes
the same three .dat files, byte for byte, as the JAX package's
`native.gen_tet_mesh`, and the same mesh as the port's `generate.box_tet`
(tests/test_native.py's check).  The port's standalone programs, built by
`host_native.binary`, against the JAX package's native/build ones:
`pfem_gentet` writes the same files; `pfem_partition 3 4 {0,1} 4 nodes
elems out.vtk` prints the same report (edge cut included) and writes the
same VTK bytes.
"""

import filecmp
import subprocess
from pathlib import Path

import numpy as np
import pytest

from pfemfort_tpu import native
from pfemfort_tpu_torch import host_native
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.mesh import io as mesh_io

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the JAX package's libpfemnative.so is "
    "not built (make -C pfemfort_tpu/native)")

JAX_BUILD = Path(native.__file__).parent / "build"
PARTS = ("nodes", "elems", "DirichBC")
BOXES = {"cube": (0, 1, 3, 0, 2, 3, 0, 1, 3),
         "skewed": (-0.5, 1.25, 5, 0, 0.3, 2, 1, 4, 7)}


def _same_files(a, b):
    return {p: filecmp.cmp(f"{a}-{p}.dat", f"{b}-{p}.dat", shallow=False)
            for p in PARTS}


@pytest.mark.parametrize("box", sorted(BOXES))
def test_gen_tet_mesh_files_are_jax_bytes(tmp_path, box):
    args = BOXES[box]
    native.gen_tet_mesh(*args, str(tmp_path / "jax"))
    host_native.gen_tet_mesh(*args, str(tmp_path / "port"))
    assert _same_files(tmp_path / "jax", tmp_path / "port") == \
        dict.fromkeys(PARTS, True)


def test_gen_tet_mesh_matches_box_tet(tmp_path):
    prefix = str(tmp_path / "nat")
    host_native.gen_tet_mesh(0, 1, 3, 0, 2, 3, 0, 1, 3, prefix)
    mesh_n, dbc_n, _ = mesh_io.read_problem(prefix)
    mesh_p, dbc_p = generate.box_tet(0, 1, 3, 0, 2, 3, 0, 1, 3)
    assert np.allclose(mesh_n.coords, mesh_p.coords, atol=1e-8)
    assert (mesh_n.conn == mesh_p.conn).all()
    dn = {(int(r[0]), int(r[1])): r[2] for r in dbc_n}
    dp = {(int(r[0]), int(r[1])): r[2] for r in dbc_p}
    assert set(dn) == set(dp)
    assert max(abs(dn[k] - dp[k]) for k in dn) < 1e-8


def test_gentet_program_writes_jax_files(tmp_path):
    args = [str(v) for v in BOXES["skewed"]]
    for who, exe in (("jax", JAX_BUILD / "pfem_gentet"),
                     ("port", host_native.binary("pfem_gentet"))):
        out = subprocess.run([str(exe), *args, str(tmp_path / who)],
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stderr
    assert _same_files(tmp_path / "jax", tmp_path / "port") == \
        dict.fromkeys(PARTS, True)


@pytest.mark.parametrize("method", [0, 1])
def test_partition_program_matches_jax(tmp_path, method):
    prefix = str(tmp_path / "box")
    native.gen_tet_mesh(0, 1, 3, 0, 1, 3, 0, 1, 3, prefix)
    runs = {}
    for who, exe in (("jax", JAX_BUILD / "pfem_partition"),
                     ("port", host_native.binary("pfem_partition"))):
        vtk = tmp_path / f"{who}.vtk"
        out = subprocess.run(
            [str(exe), "3", "4", str(method), "4", f"{prefix}-nodes.dat",
             f"{prefix}-elems.dat", str(vtk)], capture_output=True,
            text=True)
        assert out.returncode == 0, out.stderr
        runs[who] = (out.stdout.replace(str(vtk), "OUT"), vtk.read_bytes())
    assert "edge-cut" in runs["port"][0]
    assert runs["port"] == runs["jax"]
    assert b"SCALARS procid int 1" in runs["port"][1]


def test_binary_names_its_programs():
    with pytest.raises(ValueError, match="pfem_gentet"):
        host_native.binary("pfem_native")
