# Ported from pfemfort_tpu/elements/elasticity.py.
"""Batched linear-elasticity element kernels (torch) — element-minor layout.

Redesign of the reference's elasticity element subroutines
(PFEMFort src/elementutilitieselasticity2D.F,
 PFEMFort src/elementutilitieselasticity3D.F): tensor passes over
all elements with the element axis LAST (see geometry.py's layout rule).

Reference conventions honored (quirks and all, as in the JAX package):
  * Implicit 2D tria uses the PLANE-STRESS D with D33 = E(1-nu)/(1-nu^2)
    (elasticity2D.F:61-66); explicit 2D kernels use PLANE STRAIN
    (elasticity2D.F:202-206).  The reference's D33 has no 1/2 factor
    while its B-matrix rows carry engineering shear — reproduced exactly in
    `dmat_plane_stress`.
  * Explicit residual kernels compute stress from TENSORIAL shear strain
    (0.5*(du_c/dx_d + du_d/dx_c); elasticity2D.F:254-257,
    elasticity3D.F:127-133) — reproduced in `elasticity_residual`.
  * Body force enters the implicit RHS as dvol*N*bforce (no density;
    elasticity2D.F:146-149) but the explicit residual as dens*dvol*N*bforce
    (elasticity2D.F:268-271) — callers pick via the `dens` argument.
  * Lumped mass is the row-sum of the consistent mass
    (elasticity2D.F:353-360).  The reference's tetra stiffness/mass declare
    nGP=8 but define only point 1 (elasticity3D.F:272,305,416,429 — reads of
    uninitialized rule data); the intended 1-pt rule is used.

Contractions: the JAX package unrolls its G x S sums into Python sums of
(ns, ns, E) tensors, a TPU workaround against padded dot_generals.  Here
every such sum accumulates in place into ONE output tensor (addcmul_ over
element-minor operands), in the JAX package's (g outer, s inner) order: no
axis is moved to the front, nothing is copied, and hexa8 (G = 8, S = 6,
ns = 24) keeps one (24, 24, E) accumulator live instead of 48 temporaries.

DOF layout per element: node-major, component-fast — (i, c) -> i*ndof + c,
matching the reference's TI=(ii-1)*ndof+c (elasticity2D.F:127-133).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.elements.basis import tabulate_basis
from pfemfort_tpu_torch.elements.geometry import grads_and_det

# ---------------------------------------------------------------------------
# Constitutive matrices (numpy, copied as they are)
# ---------------------------------------------------------------------------


def dmat_plane_stress(E: float, nu: float) -> np.ndarray:
    """Plane-stress D exactly as the reference implicit tria kernel builds it
    (elasticity2D.F:61-66), including D33 = b1*(1-nu) (no 1/2)."""
    b1 = E / (1.0 - nu * nu)
    return np.array([
        [b1, b1 * nu, 0.0],
        [b1 * nu, b1, 0.0],
        [0.0, 0.0, b1 * (1.0 - nu)],
    ])


def dmat_plane_strain(E: float, nu: float) -> np.ndarray:
    """Plane-strain D (elasticity2D.F:203-206)."""
    b1 = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return np.array([
        [b1 * (1 - nu), b1 * nu, 0.0],
        [b1 * nu, b1 * (1 - nu), 0.0],
        [0.0, 0.0, b1 * (1 - 2 * nu) * 0.5],
    ])


def dmat_3d(E: float, nu: float) -> np.ndarray:
    """Isotropic 3D D, Voigt order (xx, yy, zz, xy, yz, zx)
    (elasticity3D.F:62-71)."""
    b1 = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = b1 * (1.0 - 2.0 * nu) / 2.0
    D = np.zeros((6, 6))
    D[:3, :3] = b1 * nu
    np.fill_diagonal(D[:3, :3], b1 * (1.0 - nu))
    D[3, 3] = D[4, 4] = D[5, 5] = mu
    return D


def _bsel(ndim: int) -> np.ndarray:
    """T[s,c,d]: engineering B-matrix selector, B[s,(j,c)] = T[s,c,d] dN_j/dx_d.

    Voigt rows: 2D (xx, yy, xy); 3D (xx, yy, zz, xy, yz, zx) — matching the
    reference B layout (elasticity2D.F:126-133, elasticity3D.F:359-371).
    """
    if ndim == 2:
        T = np.zeros((3, 2, 2))
        T[0, 0, 0] = 1.0
        T[1, 1, 1] = 1.0
        T[2, 0, 1] = 1.0
        T[2, 1, 0] = 1.0
        return T
    T = np.zeros((6, 3, 3))
    T[0, 0, 0] = 1.0
    T[1, 1, 1] = 1.0
    T[2, 2, 2] = 1.0
    T[3, 0, 1] = 1.0
    T[3, 1, 0] = 1.0
    T[4, 1, 2] = 1.0
    T[4, 2, 1] = 1.0
    T[5, 0, 2] = 1.0
    T[5, 2, 0] = 1.0
    return T


def _ssel(ndim: int) -> np.ndarray:
    """S[s,c,d]: strain selector with TENSORIAL shear (0.5 factors), the form
    the reference's residual kernels use for stress evaluation."""
    S = _bsel(ndim).copy()
    nd = 2 if ndim == 2 else 3
    S[nd:] *= 0.5
    return S


def _b_entries(ndim: int, npe: int):
    """For each Voigt row s and flat dof n=(i*ndim+c): the single (d, i, w)
    such that B[s,n] = w * dN_i/dx_d, or None (structural zero).

    The engineering B selector has at most one nonzero derivative per
    (s, c) pair, so B is a gather of gradN rows with no contraction."""
    T = _bsel(ndim)
    S = T.shape[0]
    rows = []
    for s in range(S):
        ents = []
        for i in range(npe):
            for c in range(ndim):
                nz = np.nonzero(T[s, c])[0]
                if len(nz) == 0:
                    ents.append(None)
                else:
                    d = int(nz[0])
                    ents.append((d, i, float(T[s, c, d])))
        rows.append(ents)
    return rows


def _build_B(gradN: torch.Tensor, ndim: int, npe: int) -> torch.Tensor:
    """B (G, S, ns, E) as ONE gather of the (G, ndim*npe, E) gradN rows,
    with a zero row for the structural zeros (every selector weight is 1)."""
    G, E = gradN.shape[0], gradN.shape[-1]
    zero_row = ndim * npe
    idx = [[zero_row if e is None else e[0] * npe + e[1] for e in row]
           for row in _b_entries(ndim, npe)]
    rows = torch.cat([gradN.reshape(G, ndim * npe, E),
                      gradN.new_zeros(G, 1, E)], dim=1)
    index = torch.as_tensor(np.asarray(idx, dtype=np.int64).reshape(-1),
                            device=gradN.device)
    return rows.index_select(1, index).reshape(G, len(idx), ndim * npe, E)


def _apply_D(D: np.ndarray, X: torch.Tensor) -> torch.Tensor:
    """(D @ X) over the Voigt axis 1 of X (G, S, ..., E) with static numpy D
    scalars — unrolled in the JAX package's order, skipping structural
    zeros."""
    S = D.shape[0]
    outs = []
    for s in range(S):
        acc = None
        for t in range(S):
            if D[s, t] == 0.0:
                continue
            term = float(D[s, t]) * X[:, t]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else torch.zeros_like(X[:, 0]))
    return torch.stack(outs, dim=1)


def _node_weights(N: np.ndarray, dvol: torch.Tensor) -> torch.Tensor:
    """w[i, e] = sum_g N[g, i] dvol[g, e], summed in g order: (npe, E)."""
    G, npe = N.shape
    return torch.stack([
        sum(float(N[g, i]) * dvol[g] for g in range(G)) for i in range(npe)])


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def elasticity_stiffness(
    coords_em: torch.Tensor,
    etype: str,
    D: np.ndarray,
    thickness: float = 1.0,
    bforce: Optional[Sequence[float]] = None,
    ngp: Optional[int] = None,
):
    """K = sum_g dvol B^T D B and body-force vector F = sum_g dvol N b.

    coords_em: (npe, ndim, E).  Returns K (ns, ns, E), F (ns, E) with
    ns = npe*ndim, in coords_em's dtype and on its device.
    """
    dtype, device = coords_em.dtype, coords_em.device
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    G, ndim, npe = dNdu.shape
    ns = npe * ndim
    E_ = coords_em.shape[2]
    Dnp = np.asarray(D, dtype=np.float64)
    S = Dnp.shape[0]
    wts = torch.as_tensor(wts, dtype=dtype, device=device)

    gradN, det = grads_and_det(coords_em, dNdu)   # (G,d,i,E), (G,E)
    dvol = wts[:, None] * det * thickness         # (G, E)

    B = _build_B(gradN, ndim, npe)                # (G,S,ns,E)
    DB = _apply_D(Dnp, B)
    # K[n,m,e] = sum_{g,s} dvol[g,e] B[g,s,n,e] DB[g,s,m,e], accumulated in
    # place in (g, s) order
    K = coords_em.new_zeros(ns, ns, E_)
    for g in range(G):
        for s in range(S):
            K.addcmul_((dvol[g][None, :] * B[g, s])[:, None, :],
                       DB[g, s][None, :, :])

    if bforce is None:
        F = coords_em.new_zeros(ns, E_)
    else:
        bnp = np.asarray(bforce, dtype=np.float64)
        w = _node_weights(np.asarray(N, dtype=np.float64), dvol)
        # F[(i,c)] = b_c * w_i
        F = torch.stack([float(bnp[c]) * w[i]
                         for i in range(npe) for c in range(ndim)])
    return K, F


class ResidualGeometry(NamedTuple):
    """What `elasticity_residual` needs of the mesh alone, computed once
    per mesh (the explicit time loop reuses it every step)."""

    npe: int
    ndim: int
    gradN: torch.Tensor     # (G, ndim, npe, E)
    dvolB: torch.Tensor     # (G, S, ns, E): dvol[g] * B[g, s]
    wnode: torch.Tensor     # (npe, E): sum_g N[g, i] dvol[g]


def residual_geometry(coords_em: torch.Tensor, etype: str,
                      thickness: float = 1.0,
                      ngp: Optional[int] = None) -> ResidualGeometry:
    dtype, device = coords_em.dtype, coords_em.device
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    G, ndim, npe = dNdu.shape
    wts = torch.as_tensor(wts, dtype=dtype, device=device)
    gradN, det = grads_and_det(coords_em, dNdu)
    dvol = wts[:, None] * det * thickness  # (G, E)
    B = _build_B(gradN, ndim, npe)
    return ResidualGeometry(
        npe=npe, ndim=ndim, gradN=gradN,
        dvolB=dvol[:, None, None, :] * B,
        wnode=_node_weights(np.asarray(N, dtype=np.float64), dvol))


def apply_residual(geom: ResidualGeometry, disp_em: torch.Tensor,
                   D: np.ndarray, dens: float,
                   bforce: torch.Tensor) -> torch.Tensor:
    """The residual F = dens*dvol*N*b - B^T sigma for a precomputed
    geometry; see `elasticity_residual`."""
    npe, ndim, gradN = geom.npe, geom.ndim, geom.gradN
    G, E_ = gradN.shape[0], gradN.shape[-1]
    Snp = _ssel(ndim)
    Dnp = np.asarray(D, dtype=np.float64)
    nS = Dnp.shape[0]

    # grad_disp[g,c,d,e] = sum_i disp[(i,c),e] dN_i/dx_d, summed in i order
    disp3 = disp_em.reshape(npe, ndim, E_)
    gd = disp3[0][None, :, None, :] * gradN[:, None, :, 0, :]
    for i in range(1, npe):
        gd.addcmul_(disp3[i][None, :, None, :], gradN[:, None, :, i, :])
    # tensorial strain + stress with static selector/constitutive scalars
    strain = torch.stack([
        sum(float(Snp[s, c, d]) * gd[:, c, d, :]
            for c in range(ndim) for d in range(ndim)
            if Snp[s, c, d] != 0.0)
        for s in range(nS)
    ], dim=1)                               # (G, S, E)
    stress = _apply_D(Dnp, strain)

    Fint = geom.dvolB[0, 0] * stress[0, 0][None, :]
    for g in range(G):
        for s in range(nS):
            if g or s:
                Fint.addcmul_(geom.dvolB[g, s], stress[g, s][None, :])
    b = torch.as_tensor(bforce, dtype=disp_em.dtype, device=disp_em.device)
    # Fbody[(i,c)] = dens * (sum_g dvol N_i) * b_c
    Fbody = dens * (geom.wnode[:, None, :] * b[None, :, None]).reshape(
        npe * ndim, E_)
    return Fbody - Fint


def elasticity_residual(
    coords_em: torch.Tensor,
    disp_em: torch.Tensor,
    etype: str,
    D: np.ndarray,
    dens: float,
    bforce,
    thickness: float = 1.0,
    ngp: Optional[int] = None,
) -> torch.Tensor:
    """Explicit-dynamics residual F = dens*dvol*N*b - B^T sigma for all elems.

    disp_em: (ns, E) element nodal displacements, node-major dof-fast.
    bforce: (ndim,) tensor or sequence (time-dependent pulse in the drivers).
    Stress uses tensorial shear strain, exactly like the reference residual
    kernels (elasticity2D.F:254-271, elasticity3D.F:127-150).
    Returns F (ns, E).
    """
    geom = residual_geometry(coords_em, etype, thickness=thickness, ngp=ngp)
    return apply_residual(geom, disp_em, D, dens, bforce)


def lumped_mass(
    coords_em: torch.Tensor,
    etype: str,
    dens: float,
    ndof: int,
    ngp: Optional[int] = None,
) -> torch.Tensor:
    """Row-sum lumped mass vector per element, (npe*ndof, E).

    M[(i,c)] = sum_g dens * w_g |J|_g * N_i * (sum_j N_j), replicated over
    dofs — the row-sum of the reference's block-diagonal consistent mass
    (elasticity2D.F:334-360).
    """
    dtype, device = coords_em.dtype, coords_em.device
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    G, _, npe = dNdu.shape
    wts = torch.as_tensor(wts, dtype=dtype, device=device)
    Nnp = np.asarray(N, dtype=np.float64)
    _, det = grads_and_det(coords_em, dNdu)
    dvol = wts[:, None] * det * dens  # (G, E)
    rowsum = Nnp.sum(axis=1)  # (G,) == 1 for partition-of-unity bases
    Mnode = torch.stack([
        sum(float(Nnp[g, i] * rowsum[g]) * dvol[g] for g in range(G))
        for i in range(npe)
    ])  # (npe, E)
    return Mnode.repeat_interleave(ndof, dim=0)


class QuadHGGeometry(NamedTuple):
    """The 1-point quad's closed-form midpoint geometry, element-minor."""
    dNdx: torch.Tensor   # (4, E); rows 2, 3 are -rows 0, 1
    dNdy: torch.Tensor   # (4, E)
    area: torch.Tensor   # (E,)


def quad_hg_geometry(coords_em: torch.Tensor) -> QuadHGGeometry:
    """The midpoint gradients and area of ResidualElasticityLinearQuadHG
    (elasticity2D.F:700-889) from coords_em (4, 2, E).  The explicit loop's
    card set-up keeps rows 0 and 1 of each and the area for kernel B3's
    hourglass pass, which forms the rest as quad_hg_residual does."""
    x = coords_em[:, 0, :]   # (4, E)
    y = coords_em[:, 1, :]
    area = 0.5 * ((x[2] - x[0]) * (y[3] - y[1])
                  + (x[1] - x[3]) * (y[2] - y[0]))
    fact = 2.0 * area
    dNdx = torch.stack([
        (y[1] - y[3]) / fact,
        (y[2] - y[0]) / fact,
        -(y[1] - y[3]) / fact,
        -(y[2] - y[0]) / fact,
    ])  # (4, E)
    dNdy = torch.stack([
        (x[3] - x[1]) / fact,
        (x[0] - x[2]) / fact,
        -(x[3] - x[1]) / fact,
        -(x[0] - x[2]) / fact,
    ])
    return QuadHGGeometry(dNdx, dNdy, area)


def quad_hg_viscosity(dens: float, hg_visc: float = 1.0,
                      wave_speed: float = 50.0) -> float:
    """The hourglass force's factor 0.25 hg_visc dens c before sqrt|A|, in
    the host's double as the residual forms it."""
    return 0.25 * hg_visc * dens * wave_speed


def _sum4(a: torch.Tensor) -> torch.Tensor:
    """The sum over a (4, E) tensor's rows, in row order (the order kernel
    B3's hourglass pass keeps)."""
    return ((a[0] + a[1]) + a[2]) + a[3]


def quad_hg_residual(
    coords_em: torch.Tensor,
    disp_em: torch.Tensor,
    velo_em: torch.Tensor,
    E: float,
    nu: float,
    dens: float,
    bforce,
    thickness: float = 0.025,
    hg_visc: float = 1.0,
    wave_speed: float = 50.0,
) -> torch.Tensor:
    """1-point quad residual with viscous hourglass control.

    Re-implements ResidualElasticityLinearQuadHG
    (PFEMFort src/elementutilitieselasticity2D.F:700-889): closed-form
    midpoint B-matrix, PLANE-STRESS stress from tensorial shear strain, and
    the viscous hourglass force H = -0.25*hg_visc*dens*c*sqrt(A) * (Gamma.v)
    with Gamma = [+1,-1,+1,-1] and the hard-coded wave-speed override
    m_WAVES = 50.0 (elasticity2D.F:869) and thick = 0.025 (:734).

    coords_em (4, 2, E); disp_em/velo_em (8, E).  Returns (8, E).
    """
    dtype, device = coords_em.dtype, coords_em.device
    dNdx, dNdy, area = quad_hg_geometry(coords_em)

    d3 = disp_em.reshape(4, 2, -1)
    ux, uy = d3[:, 0, :], d3[:, 1, :]   # (4, E)
    g11 = _sum4(ux * dNdx)
    g12 = _sum4(ux * dNdy)
    g21 = _sum4(uy * dNdx)
    g22 = _sum4(uy * dNdy)
    strain = torch.stack([g11, g22, 0.5 * (g12 + g21)])  # (3, E)
    Dnp = dmat_plane_stress(E, nu)
    stress = torch.stack([
        sum(float(Dnp[s, t]) * strain[t] for t in range(3)
            if Dnp[s, t] != 0.0)
        for s in range(3)
    ])

    dvol = area * thickness
    Nmid = 0.25
    b = torch.as_tensor(bforce, dtype=dtype, device=device)
    Fx = (dens * dvol * Nmid)[None, :] * b[0] \
        - dvol[None, :] * (dNdx * stress[0][None, :]
                           + dNdy * stress[2][None, :])
    Fy = (dens * dvol * Nmid)[None, :] * b[1] \
        - dvol[None, :] * (dNdx * stress[2][None, :]
                           + dNdy * stress[1][None, :])

    # Hourglass viscous force
    hg = quad_hg_viscosity(dens, hg_visc, wave_speed) \
        * torch.sqrt(torch.abs(area))
    v3 = velo_em.reshape(4, 2, -1)
    vx, vy = v3[:, 0, :], v3[:, 1, :]
    gamma = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dtype, device=device)
    H1 = -(vx[0] - vx[1] + vx[2] - vx[3]) * hg
    H2 = -(vy[0] - vy[1] + vy[2] - vy[3]) * hg
    Fx = Fx + gamma[:, None] * H1[None, :]
    Fy = Fy + gamma[:, None] * H2[None, :]

    return torch.stack([Fx, Fy], dim=1).reshape(8, -1)
