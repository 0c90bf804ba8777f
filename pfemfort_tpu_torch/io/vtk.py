# Copied from pfemfort_tpu/io/vtk.py.
"""Legacy ASCII VTK writer matching the reference's writervtk.F layout
(PFEMFort src/writervtk.F:33-201): UNSTRUCTURED_GRID points, cells,
CELL_DATA `procid`, POINT_DATA scalar (ndof=1) or vector solution."""

from __future__ import annotations

from typing import Optional

import numpy as np

from pfemfort_tpu_torch.mesh.core import Mesh

# hexa8 connectivity is stored lattice-bit order internally; VTK wants the
# counter-clockwise ring order.
_VTK_NODE_ORDER = {"hexa8": np.array([0, 1, 3, 2, 4, 5, 7, 6])}


def write_vtk(
    path: str,
    mesh: Mesh,
    soln: np.ndarray,
    ndof: int,
    elem_procid: Optional[np.ndarray] = None,
    title: str = "pfemfort_tpu output",
) -> None:
    """Write mesh + per-cell procid + nodal solution as legacy ASCII VTK."""
    coords = mesh.coords
    conn = mesh.conn
    if mesh.etype in _VTK_NODE_ORDER:
        conn = conn[:, _VTK_NODE_ORDER[mesh.etype]]
    if elem_procid is None:
        elem_procid = np.zeros(mesh.n_elem, dtype=np.int32)
    soln = np.asarray(soln, dtype=np.float64).reshape(-1)

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 4.0\n")
        f.write(title + "\n")
        f.write(" ASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")

        f.write(f"POINTS {mesh.n_node:10d} float\n")
        if mesh.ndim == 2:
            pts = np.column_stack([coords, np.zeros(mesh.n_node)])
        else:
            pts = coords
        for p in pts:
            f.write(f"{p[0]:12.6f}{p[1]:12.6f}{p[2]:12.6f}\n")

        ind = mesh.n_elem * (mesh.npe + 1)
        f.write(f"CELLS {mesh.n_elem:10d}{ind:10d}\n")
        for row in conn:
            f.write(f"{mesh.npe:10d}" + "".join(f"{n:10d}" for n in row) + "\n")

        f.write(f"CELL_TYPES{mesh.n_elem:10d}\n")
        for _ in range(mesh.n_elem):
            f.write(f"{mesh.vtk_type:3d}\n")

        f.write(f"CELL_DATA{mesh.n_elem:10d}\n")
        f.write("SCALARS procid int 1\n")
        f.write("LOOKUP_TABLE default\n")
        for p in elem_procid:
            f.write(f"{int(p):3d}\n")

        f.write(f"POINT_DATA{mesh.n_node:10d}\n")
        if ndof == 1:
            f.write("SCALARS solution float 1\n")
            f.write("LOOKUP_TABLE default\n")
            for v in soln:
                f.write(f"{v:12.6f}\n")
        else:
            f.write("VECTORS solution float\n")
            s = soln.reshape(-1, ndof)
            for row in s:
                vals = list(row) + [0.0] * (3 - ndof)
                f.write(f"{vals[0]:12.6f}{vals[1]:12.6f}{vals[2]:12.6f}\n")


def vtk_to_vtu(vtk_path: str, vtu_path: str) -> None:
    """Convert a legacy VTK (as written above) to XML .vtu.

    Counterpart of the reference's VTK-library converter
    (PFEMFort src/vtktovtu.cpp:8-28), implemented directly.
    """
    import re

    with open(vtk_path) as f:
        text = f.read()

    def _block(after: str, count: int, per_line: int | None = None):
        start = text.index(after)
        rest = text[start:].split("\n", 1)[1]
        vals = rest.split()
        return vals

    m = re.search(r"POINTS\s+(\d+)\s+float", text)
    n_pts = int(m.group(1))
    vals = text[m.end():].split()
    pts = np.array(vals[: 3 * n_pts], dtype=np.float64).reshape(n_pts, 3)

    m = re.search(r"CELLS\s+(\d+)\s+(\d+)", text)
    n_cells, tot = int(m.group(1)), int(m.group(2))
    vals = text[m.end():].split()
    cells_flat = np.array(vals[:tot], dtype=np.int64)
    npe = int(cells_flat[0])
    conn = cells_flat.reshape(n_cells, npe + 1)[:, 1:]

    m = re.search(r"CELL_TYPES\s+(\d+)", text)
    vals = text[m.end():].split()
    ctypes = np.array(vals[:n_cells], dtype=np.int64)

    m = re.search(r"SCALARS procid int 1\s+LOOKUP_TABLE default", text)
    procid = None
    if m:
        vals = text[m.end():].split()
        procid = np.array(vals[:n_cells], dtype=np.int64)

    sol = None
    ncomp = 1
    m = re.search(r"SCALARS solution float 1\s+LOOKUP_TABLE default", text)
    if m:
        vals = text[m.end():].split()
        sol = np.array(vals[:n_pts], dtype=np.float64)
    else:
        m = re.search(r"VECTORS solution float", text)
        if m:
            vals = text[m.end():].split()
            sol = np.array(vals[: 3 * n_pts], dtype=np.float64).reshape(n_pts, 3)
            ncomp = 3

    offsets = np.arange(1, n_cells + 1) * npe
    with open(vtu_path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{n_pts}" '
                f'NumberOfCells="{n_cells}">\n')
        f.write("      <Points>\n")
        f.write('        <DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        for p in pts:
            f.write(f"          {p[0]} {p[1]} {p[2]}\n")
        f.write("        </DataArray>\n      </Points>\n")
        f.write("      <Cells>\n")
        f.write('        <DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n')
        for row in conn:
            f.write("          " + " ".join(map(str, row)) + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        f.write("          " + " ".join(map(str, offsets)) + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write("          " + " ".join(map(str, ctypes)) + "\n")
        f.write("        </DataArray>\n      </Cells>\n")
        if procid is not None:
            f.write("      <CellData>\n")
            f.write('        <DataArray type="Int32" Name="procid" '
                    'format="ascii">\n')
            f.write("          " + " ".join(map(str, procid)) + "\n")
            f.write("        </DataArray>\n      </CellData>\n")
        if sol is not None:
            f.write("      <PointData>\n")
            f.write(f'        <DataArray type="Float64" Name="solution" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            flat = sol.reshape(-1)
            f.write("          " + " ".join(f"{v}" for v in flat) + "\n")
            f.write("        </DataArray>\n      </PointData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")
