# Copied from pfemfort_tpu/mesh/io.py.
"""Readers/writers for the reference's ASCII `.dat` mesh format.

Format (1-based, whitespace separated; counts discovered by counting lines,
as the reference drivers do — PFEMFort src/triapoissonserialimpl1.F:184-295):
  nodes  : ``id x y [z]``
  elems  : ``id n1 n2 n3 [n4 n5 n6 n7 n8]``
  DirichBC / ForceBC : ``node dof value``

Gzipped files (``*.dat.gz``) are read transparently (the bundled reference
meshes are stored gzipped).
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from pfemfort_tpu_torch.mesh.core import Mesh, etype_from_shape


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rt")
    return open(path, "r")


def _loadtxt(path: str) -> np.ndarray:
    with _open(path) as f:
        arr = np.loadtxt(f, ndmin=2)
    return arr


def read_nodes(path: str) -> np.ndarray:
    """Read a nodes file -> (n_node, ndim) float64; column 0 (id) dropped."""
    arr = _loadtxt(path)
    return np.ascontiguousarray(arr[:, 1:], dtype=np.float64)


def read_elems(path: str) -> np.ndarray:
    """Read an elems file -> (n_elem, npe) int32, converted to 0-based."""
    arr = _loadtxt(path)
    return np.ascontiguousarray(arr[:, 1:], dtype=np.int64).astype(np.int32) - 1


def read_bcs(path: Optional[str]) -> np.ndarray:
    """Read DirichBC/ForceBC -> (n, 3): [node0, dof0, value] (0-based ids)."""
    if path is None:
        return np.zeros((0, 3), dtype=np.float64)
    arr = _loadtxt(path)
    out = np.empty((arr.shape[0], 3), dtype=np.float64)
    out[:, 0] = arr[:, 0] - 1
    out[:, 1] = arr[:, 1] - 1
    out[:, 2] = arr[:, 2]
    return out


def read_mesh(nodes_path: str, elems_path: str) -> Mesh:
    coords = read_nodes(nodes_path)
    conn = read_elems(elems_path)
    etype = etype_from_shape(coords.shape[1], conn.shape[1])
    return Mesh(etype, coords, conn)


def read_problem(prefix: str, with_force: bool = False):
    """Read the `<prefix>-{nodes,elems,DirichBC[,ForceBC]}.dat` triplet/quad.

    Mirrors the CLI convention of every reference solver executable
    (PFEMFort bin/makefile:3-11).
    """
    mesh = read_mesh(prefix + "-nodes.dat", prefix + "-elems.dat")
    dbc = read_bcs(prefix + "-DirichBC.dat")
    fbc = None
    fpath = prefix + "-ForceBC.dat"
    if with_force or os.path.exists(fpath) or os.path.exists(fpath + ".gz"):
        try:
            fbc = read_bcs(fpath)
        except (OSError, IOError):
            fbc = None
    return mesh, dbc, fbc


def write_dat(prefix: str, mesh: Mesh, dirichlet: Optional[np.ndarray] = None,
              force: Optional[np.ndarray] = None) -> None:
    """Write the `.dat` triplet in the reference's 1-based format."""
    with open(prefix + "-nodes.dat", "w") as f:
        for i, xyz in enumerate(mesh.coords):
            f.write(str(i + 1) + "\t" + "\t".join(f"{v:.8f}" for v in xyz) + "\n")
    with open(prefix + "-elems.dat", "w") as f:
        for i, nodes in enumerate(mesh.conn):
            f.write(str(i + 1) + "\t" + "\t".join(str(n + 1) for n in nodes) + "\n")
    if dirichlet is not None:
        with open(prefix + "-DirichBC.dat", "w") as f:
            for n, d, v in dirichlet:
                f.write(f"{int(n) + 1}\t{int(d) + 1}\t{v:.8f}\n")
    if force is not None:
        with open(prefix + "-ForceBC.dat", "w") as f:
            for n, d, v in force:
                f.write(f"{int(n) + 1}\t{int(d) + 1}\t{v:.8f}\n")


def write_partitioned(prefix: str, mesh: Mesh, n_parts: int,
                      dirichlet: Optional[np.ndarray] = None,
                      method: str = "slab") -> np.ndarray:
    """Write per-rank mesh files `<prefix>-p<k>-{nodes,elems,DirichBC,gids}.dat`.

    The scalable input mode triapoissonparallelimpl2 sketches (per-rank
    filename suffix, each rank reading only its subdomain;
    PFEMFort src/triapoissonparallelimpl2.F:188-231).  Local files use
    local 1-based node numbering; `-gids.dat` maps local -> global (1-based).
    Returns the element partition array.
    """
    from pfemfort_tpu_torch.parallel.partition import partition_elements

    part = partition_elements(mesh, n_parts, method=method)
    for k in range(n_parts):
        els = np.nonzero(part == k)[0]
        conn_k = mesh.conn[els]
        gnodes = np.unique(conn_k)
        l_of_g = np.full(mesh.n_node, -1, dtype=np.int64)
        l_of_g[gnodes] = np.arange(len(gnodes))
        sub = Mesh(mesh.etype, mesh.coords[gnodes], l_of_g[conn_k])
        dbc_k = None
        if dirichlet is not None and len(dirichlet):
            keep = l_of_g[dirichlet[:, 0].astype(np.int64)] >= 0
            dbc_k = dirichlet[keep].copy()
            dbc_k[:, 0] = l_of_g[dbc_k[:, 0].astype(np.int64)]
        write_dat(f"{prefix}-p{k}", sub, dirichlet=dbc_k)
        with open(f"{prefix}-p{k}-gids.dat", "w") as f:
            for i, g in enumerate(gnodes):
                f.write(f"{i + 1}\t{g + 1}\n")
    return part


def read_partitioned(prefix: str, rank: int):
    """Read rank-local mesh files written by `write_partitioned`.

    Returns (mesh_local, dirichlet_local, node_gids) with node_gids the
    0-based global node id of each local node.
    """
    mesh, dbc, _ = read_problem(f"{prefix}-p{rank}")
    arr = _loadtxt(f"{prefix}-p{rank}-gids.dat")
    gids = arr[:, 1].astype(np.int64) - 1
    return mesh, dbc, gids
