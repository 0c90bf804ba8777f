# Copied from pfemfort_tpu/mesh/generate.py (box_tet and its helpers only).
"""Structured box-tet mesh generator (host-side numpy).

`box_tet`: box -> hexes -> 6 tets each, with Dirichlet u = x^2+y^2+z^2 on
all six faces — same node lattice (x fastest, then y, then z), the same
6-tet split pattern and the same BC field as genTetra
(/root/reference/src/genTetranovtk.cpp:130-208, genTetra.cpp:516-524).

All generators return 0-based connectivity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from pfemfort_tpu_torch.mesh.core import Mesh

# The fixed hex->6-tet split (corner indices into the hex's 8 nodes, using the
# reference's lattice corner order pts[0..7] = (x,y,z) bit pattern with x
# fastest; /root/reference/src/genTetranovtk.cpp:203-208).
_TET_SPLIT = np.array(
    [
        [0, 1, 3, 5],
        [0, 3, 2, 5],
        [2, 3, 7, 5],
        [4, 6, 7, 2],
        [4, 7, 5, 2],
        [0, 4, 5, 2],
    ],
    dtype=np.int32,
)


def _lattice(x0, x1, nex, y0, y1, ney, z0=None, z1=None, nez=None):
    xs = np.linspace(x0, x1, nex + 1)
    ys = np.linspace(y0, y1, ney + 1)
    if nez is None:
        Y, X = np.meshgrid(ys, xs, indexing="ij")  # y slow, x fast
        return np.stack([X.ravel(), Y.ravel()], axis=1)
    zs = np.linspace(z0, z1, nez + 1)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")  # z slowest, x fastest
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)


def box_tet(x0, x1, nex, y0, y1, ney, z0, z1, nez,
            bc_fn=None) -> Tuple[Mesh, np.ndarray]:
    """Box tetrahedral mesh with boundary Dirichlet values.

    Element ordering matches the reference generator: for each hex (x fastest,
    then y, then z) emit its 6 tets in the fixed split order.  Default BC
    value is u = x^2 + y^2 + z^2 on every boundary node (the manufactured
    solution of the 3D Poisson benchmark; genTetra.cpp:516-524).
    """
    coords = _lattice(x0, x1, nex, y0, y1, ney, z0, z1, nez)
    # Order hexes exactly like the reference triple loop: kk slow, jj, ii
    # fast.  conn is built by 24 broadcast WRITES (one per (class, corner))
    # instead of a (n_hex, 6, 4) fancy-index gather — ~2x less host memory
    # traffic, which dominates at the 48M-element scale.
    nnx, nny = nex + 1, ney + 1
    base = (np.arange(nez, dtype=np.int32)[:, None, None] * (nnx * nny)
            + np.arange(ney, dtype=np.int32)[None, :, None] * nnx
            + np.arange(nex, dtype=np.int32)[None, None, :])
    offs = np.array(
        [0, 1, nnx, nnx + 1,
         nnx * nny, nnx * nny + 1, nnx * nny + nnx, nnx * nny + nnx + 1],
        dtype=np.int32,
    )
    conn6 = np.empty((nez, ney, nex, 6, 4), dtype=np.int32)
    for c in range(6):
        for i in range(4):
            conn6[:, :, :, c, i] = base + offs[_TET_SPLIT[c, i]]
    conn = conn6.reshape(-1, 4)
    mesh = Mesh("tetra4", coords, conn,
                structure=dict(kind="box_tet", nex=nex, ney=ney, nez=nez))

    # Boundary nodes: all 6 faces of the lattice (by lattice index — O(N)
    # boolean slicing, no per-node float comparisons).
    on_bd = np.zeros((nez + 1, ney + 1, nnx), dtype=bool)
    on_bd[0, :, :] = on_bd[-1, :, :] = True
    on_bd[:, 0, :] = on_bd[:, -1, :] = True
    on_bd[:, :, 0] = on_bd[:, :, -1] = True
    bnodes = np.nonzero(on_bd.reshape(-1))[0]
    if bc_fn is None:
        bc_fn = lambda p: p[:, 0] ** 2 + p[:, 1] ** 2 + p[:, 2] ** 2
    vals = bc_fn(coords[bnodes])
    dirichlet = np.stack(
        [bnodes.astype(np.float64), np.zeros(len(bnodes)), vals], axis=1)
    return mesh, dirichlet


def box_tet_coords_em(x0, x1, nex, y0, y1, ney, z0, z1, nez,
                      dtype=np.float32) -> np.ndarray:
    """Element-minor coordinates (npe=4, ndim=3, E) of the box_tet mesh,
    built DIRECTLY from the lattice axes by broadcast writes — no conn
    gather, no transpose copies.  Identical (up to dtype rounding) to
    `to_element_minor(mesh.elem_coords())` for `box_tet(...)`; at 48M
    elements this is the difference between ~10 s of fancy-index gather and
    ~3 s of sequential writes."""
    xs = np.linspace(x0, x1, nex + 1).astype(dtype)
    ys = np.linspace(y0, y1, ney + 1).astype(dtype)
    zs = np.linspace(z0, z1, nez + 1).astype(dtype)
    E = nez * ney * nex * 6
    out = np.empty((4, 3, E), dtype=dtype)
    view = out.reshape(4, 3, nez, ney, nex, 6)
    for c in range(6):
        for i in range(4):
            k = int(_TET_SPLIT[c, i])
            bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
            view[i, 0, :, :, :, c] = xs[bx:bx + nex][None, None, :]
            view[i, 1, :, :, :, c] = ys[by:by + ney][None, :, None]
            view[i, 2, :, :, :, c] = zs[bz:bz + nez][:, None, None]
    return out
