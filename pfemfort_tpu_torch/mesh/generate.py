# Copied from pfemfort_tpu/mesh/generate.py (box_tet_coords_em_device ported to torch).
"""Structured mesh generators (host-side numpy).

Re-creates the reference's offline mesh tools as vectorized numpy:
  * `box_tet`: box -> hexes -> 6 tets each, with Dirichlet u = x^2+y^2+z^2 on
    all six faces — same node lattice (x fastest, then y, then z), the same
    6-tet split pattern and the same BC field as genTetra
    (PFEMFort src/genTetranovtk.cpp:130-208, genTetra.cpp:516-524).
  * `rect_tria`: the tria20x20-style unit-square triangulation (each grid quad
    split into two triangles, matching input/tria20x20-elems.dat).
  * `rect_quad`, `rect_tria6`, `box_hexa`, `box_prism`: structured quad /
    quadratic-triangle / hex / prism grids for the explicit-dynamics element
    types.

All generators return 0-based connectivity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.mesh.core import Mesh

# The fixed hex->6-tet split (corner indices into the hex's 8 nodes, using the
# reference's lattice corner order pts[0..7] = (x,y,z) bit pattern with x
# fastest; PFEMFort src/genTetranovtk.cpp:203-208).
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


def _hex_corner_ids(nex, ney, nez):
    """(n_hex, 8) node ids of every hex cell, x fastest; corner order = the
    reference's pts[0..7]."""
    nnx, nny = nex + 1, ney + 1
    ii, jj, kk = np.meshgrid(
        np.arange(nex), np.arange(ney), np.arange(nez), indexing="ij")
    ii, jj, kk = ii.ravel(order="F"), jj.ravel(order="F"), kk.ravel(order="F")
    base = kk * (nnx * nny) + jj * nnx + ii
    # pts[0]=base, pts[1]=+x, pts[2]=+y, pts[3]=+x+y, pts[4..7]=same +z
    offs = np.array(
        [0, 1, nnx, nnx + 1,
         nnx * nny, nnx * nny + 1, nnx * nny + nnx, nnx * nny + nnx + 1],
        dtype=np.int64,
    )
    return (base[:, None] + offs[None, :]).astype(np.int32)


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


def box_tet_coords_em_device(x0, x1, nex, y0, y1, ney, z0, z1, nez,
                             dtype=torch.float32, *, device
                             ) -> torch.Tensor:
    """`box_tet_coords_em` built on `device` from three aranges: lattice
    coordinates are affine in the cell index, so the (4, 3, E) tensor is
    broadcast multiply-adds, with no host build and no host-to-device copy.
    Values differ from the linspace build by rounding of the working
    dtype."""
    hx = (x1 - x0) / nex
    hy = (y1 - y0) / ney
    hz = (z1 - z0) / nez
    ar = lambda m: torch.arange(m, dtype=dtype, device=device)
    kk = ar(nez)[:, None, None, None]
    jj = ar(ney)[None, :, None, None]
    ii = ar(nex)[None, None, :, None]
    shape = (nez, ney, nex, 6)
    cst = lambda v: torch.tensor(v, dtype=dtype, device=device)
    rows = []
    for i in range(4):
        bits = [int(_TET_SPLIT[c, i]) for c in range(6)]
        bx, by, bz = (cst([(k >> s) & 1 for k in bits]) for s in range(3))
        rows.append(torch.stack([
            (cst(x0) + cst(hx) * (ii + bx)).expand(shape),
            (cst(y0) + cst(hy) * (jj + by)).expand(shape),
            (cst(z0) + cst(hz) * (kk + bz)).expand(shape),
        ]))
    return torch.stack(rows).reshape(4, 3, -1)


def rect_tria(x0, x1, nex, y0, y1, ney) -> Mesh:
    """Unit-square-style triangulation: each grid quad -> 2 triangles
    (bl,br,tr) + (bl,tr,tl), matching input/tria20x20-elems.dat."""
    coords = _lattice(x0, x1, nex, y0, y1, ney)
    nnx = nex + 1
    jj, ii = np.meshgrid(np.arange(ney), np.arange(nex), indexing="ij")
    bl = (jj * nnx + ii).ravel()
    br, tl = bl + 1, bl + nnx
    tr = tl + 1
    t1 = np.stack([bl, br, tr], axis=1)
    t2 = np.stack([bl, tr, tl], axis=1)
    conn = np.concatenate([t1[:, None, :], t2[:, None, :]], axis=1).reshape(-1, 3)
    return Mesh("tria3", coords, conn.astype(np.int32),
                structure=dict(kind="rect_tria", nex=nex, ney=ney))


def rect_quad(x0, x1, nex, y0, y1, ney) -> Mesh:
    coords = _lattice(x0, x1, nex, y0, y1, ney)
    nnx = nex + 1
    jj, ii = np.meshgrid(np.arange(ney), np.arange(nex), indexing="ij")
    bl = (jj * nnx + ii).ravel()
    conn = np.stack([bl, bl + 1, bl + 1 + nnx, bl + nnx], axis=1)
    return Mesh("quad4", coords, conn.astype(np.int32))


def rect_tria6(x0, x1, nex, y0, y1, ney) -> Mesh:
    """Quadratic triangles on a refined lattice (corner+midside nodes).

    Node order per element: 3 corners then midsides (12, 23, 31) — the
    reference's Tria6 basis ordering
    (PFEMFort src/elementutilitiesbasisfuncs.F:80-99: N4 on edge 1-2,
    N5 on edge 2-3, N6 on edge 3-1 in its xi numbering; see basis.py).
    """
    # Lattice with doubled resolution: every node of the fine lattice exists.
    coords = _lattice(x0, x1, 2 * nex, y0, y1, 2 * ney)
    nnx = 2 * nex + 1

    def nid(i, j):
        return j * nnx + i

    elems = []
    for j in range(ney):
        for i in range(nex):
            i0, j0 = 2 * i, 2 * j
            bl, br = nid(i0, j0), nid(i0 + 2, j0)
            tr, tl = nid(i0 + 2, j0 + 2), nid(i0, j0 + 2)
            # triangle 1: bl, br, tr
            elems.append([bl, br, tr,
                          nid(i0 + 1, j0), nid(i0 + 2, j0 + 1), nid(i0 + 1, j0 + 1)])
            # triangle 2: bl, tr, tl
            elems.append([bl, tr, tl,
                          nid(i0 + 1, j0 + 1), nid(i0 + 1, j0 + 2), nid(i0, j0 + 1)])
    return Mesh("tria6", coords, np.asarray(elems, dtype=np.int32))


def box_hexa(x0, x1, nex, y0, y1, ney, z0, z1, nez) -> Mesh:
    coords = _lattice(x0, x1, nex, y0, y1, ney, z0, z1, nez)
    hexes = _hex_corner_ids(nex, ney, nez)
    # Lattice-bit node order (x fastest), matching LagrangeBasisFunsHex
    # (PFEMFort src/elementutilitiesbasisfuncs.F:323-330).  The VTK
    # writer reorders to VTK-ccw on output.
    return Mesh("hexa8", coords, hexes)


def box_prism(x0, x1, nex, y0, y1, ney, z0, z1, nez) -> Mesh:
    """Each hex split into two triangular prisms (extruded rect_tria).

    Prism node order: bottom triangle then top triangle (the reference's
    LagrangeBasisFunsPrism expects triangle at xi4=-1 first;
    PFEMFort src/elementutilitiesbasisfuncs.F:387-392).
    """
    coords = _lattice(x0, x1, nex, y0, y1, ney, z0, z1, nez)
    nnx, nny = nex + 1, ney + 1
    layer = nnx * nny
    kk, jj, ii = np.meshgrid(
        np.arange(nez), np.arange(ney), np.arange(nex), indexing="ij")
    bl = (kk * layer + jj * nnx + ii).ravel()
    br, tl = bl + 1, bl + nnx
    tr = tl + 1
    p1 = np.stack([bl, br, tr, bl + layer, br + layer, tr + layer], axis=1)
    p2 = np.stack([bl, tr, tl, bl + layer, tr + layer, tl + layer], axis=1)
    conn = np.concatenate([p1[:, None, :], p2[:, None, :]], axis=1).reshape(-1, 6)
    return Mesh("prism6", coords, conn.astype(np.int32))


def boundary_nodes(mesh: Mesh) -> np.ndarray:
    """Node ids on the bounding box faces (structured-grid convenience)."""
    X = mesh.coords
    mask = np.zeros(mesh.n_node, dtype=bool)
    for d in range(mesh.ndim):
        mask |= np.isclose(X[:, d], X[:, d].min())
        mask |= np.isclose(X[:, d], X[:, d].max())
    return np.nonzero(mask)[0]
