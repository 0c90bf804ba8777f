"""Plain PyTorch reference of the reference's hourglass-controlled quad4
explicit program (PFEMFort src/quadelasticityexplicit.F), element by
element, with nothing of the program under test.  Written from the Fortran
equations:

  ResidualElasticityLinearQuadHG (elementutilitieselasticity2D.F:700-889)
      one point at the centre: the area A by the shoelace formula, the
      midpoint gradients dN_i/dx = (y_{i+1} - y_{i-1}) / 2A and
      dN_i/dy = (x_{i-1} - x_{i+1}) / 2A (nodes cyclic); the strain with
      the TENSORIAL shear 0.5 (du/dy + dv/dx); the plane-stress stress with
      D33 = b1 (1 - nu), b1 = E / (1 - nu^2) (the reference's D33 has no
      1/2: with the tensorial strain the shear stress is G gamma);
      F_i = dens dvol / 4 b - dvol sigma . grad N_i - hg (Gamma . v) Gamma_i
      with dvol = A thick, Gamma = (1, -1, 1, -1) and
      hg = 0.25 hg_visc dens m_WAVES sqrt|A|, hg_visc = 1.
  MassMatrixLinearQuad (elementutilitieselasticity2D.F:897-975)
      the row sums of the consistent mass on the 2 x 2 Gauss rule,
      M_i = dens sum_g w_g N_i |J|, the same for both components.
  The time loop (quadelasticityexplicit.F: dt and the steps at :954-956)
      central differences with lumped mass; the residual of step n reads
      the velocity the step before returned; point loads (ForceBC) added
      on every step (:1049); homogeneous Dirichlet dofs held at zero.

The reference's quirks, kept: the residual's thickness `thick` = 0.025
(elasticity2D.F:734) and wave speed m_WAVES = 50 (:869) are hard-coded
there, and taken as given here; the lumped mass carries no thickness (as
the port's and the JAX package's do, and their oracles written from
elasticity2D.F:897-975), so the effective wave speed is
sqrt(E thick / dens).  Departures: float64 throughout; the element loop
is vectorised over blocks of elements and the assembly is an index_add_;
each element's geometry is worked out from its corners less its first
corner (the same numbers, but the shoelace's products of coordinates far
from the origin would cancel to a few digits: at the configuration's
24.6 m and h = 6 mm, to none in float32).

Every function takes its dtype from its inputs, so the same code computed
in a lower precision is the benchmark's control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 1 << 23   # elements per block of element work
GAMMA = (1.0, -1.0, 1.0, -1.0)
# 2 x 2 Gauss points (weights 1) and the bilinear quad's node coordinates
GAUSS = (-1.0 / math.sqrt(3.0), 1.0 / math.sqrt(3.0))
CORNERS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


class Problem(NamedTuple):
    """One quad4 mesh with its material, on one device and in one dtype."""
    conn: torch.Tensor    # (E, 4) int64
    dofs: torch.Tensor    # (E, 8) int64, node-major
    gx: torch.Tensor      # (E, 4) dN_i/dx at the centre
    gy: torch.Tensor      # (E, 4)
    area: torch.Tensor    # (E,)
    mass: torch.Tensor    # (n_full,) lumped
    n_node: int
    E: float
    nu: float
    dens: float
    thick: float
    waves: float
    ndof: int = 2

    @property
    def n_full(self) -> int:
        return self.n_node * self.ndof


def midpoint_geometry(x: torch.Tensor):
    """(gx, gy, area) of quadrilaterals with corners x (B, 4, 2)."""
    X, Y = x[..., 0], x[..., 1]
    nxt = lambda a: torch.roll(a, -1, dims=1)     # node i + 1
    prv = lambda a: torch.roll(a, 1, dims=1)      # node i - 1
    area = 0.5 * (X * nxt(Y) - nxt(X) * Y).sum(1)
    two_a = (2.0 * area)[:, None]
    return (nxt(Y) - prv(Y)) / two_a, (prv(X) - nxt(X)) / two_a, area


def lumped_mass(x: torch.Tensor, dens: float) -> torch.Tensor:
    """(B, 4) row sums of the consistent mass, 2 x 2 Gauss."""
    m = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
    for xi in GAUSS:
        for eta in GAUSS:
            N = torch.tensor([(1 + a * xi) * (1 + b * eta) / 4
                              for a, b in CORNERS], dtype=x.dtype,
                             device=x.device)
            dxi = torch.tensor([a * (1 + b * eta) / 4 for a, b in CORNERS],
                               dtype=x.dtype, device=x.device)
            deta = torch.tensor([b * (1 + a * xi) / 4 for a, b in CORNERS],
                                dtype=x.dtype, device=x.device)
            jx = (x * dxi[None, :, None]).sum(1)       # dx/dxi   (B, 2)
            je = (x * deta[None, :, None]).sum(1)      # dx/deta
            det = jx[:, 0] * je[:, 1] - jx[:, 1] * je[:, 0]
            m = m + dens * det.abs()[:, None] * N[None, :]
    return m


def _dofs(conn: torch.Tensor) -> torch.Tensor:
    """(B, 8) dof ids of a block of elements, node-major."""
    return (conn[:, :, None] * 2 + torch.arange(2, device=conn.device)
            ).reshape(conn.shape[0], 8)


def make_problem(coords: torch.Tensor, conn: torch.Tensor, *, E: float,
                 nu: float, dens: float, thick: float,
                 waves: float) -> Problem:
    """The problem on coords' device and in coords' dtype."""
    conn = conn.to(torch.int64)
    dofs = _dofs(conn)
    gx, gy, area = [], [], []
    mass = torch.zeros(coords.shape[0] * 2, dtype=coords.dtype,
                       device=coords.device)
    for s0 in range(0, conn.shape[0], BLOCK):
        x = coords[conn[s0:s0 + BLOCK]]
        x = x - x[:, :1]             # from each element's first corner
        g = midpoint_geometry(x)
        gx.append(g[0]), gy.append(g[1]), area.append(g[2])
        me = lumped_mass(x, dens)
        mass.index_add_(0, dofs[s0:s0 + BLOCK].reshape(-1),
                        me[:, :, None].expand(-1, 4, 2).reshape(-1))
    return Problem(conn, dofs, torch.cat(gx), torch.cat(gy), torch.cat(area),
                   mass, coords.shape[0], E, nu, dens, thick, waves)


def residual(p: Problem, u: torch.Tensor, v: torch.Tensor,
             bforce: torch.Tensor) -> torch.Tensor:
    """sum over elements of F_e = body - internal + hourglass, over the full
    dof vector."""
    F = torch.zeros_like(u)
    b1 = p.E / (1.0 - p.nu * p.nu)
    gamma = torch.tensor(GAMMA, dtype=u.dtype, device=u.device)
    for s0 in range(0, p.conn.shape[0], BLOCK):
        s = slice(s0, s0 + BLOCK)
        dofs = p.dofs[s]
        ue, ve = u[dofs].reshape(-1, 4, 2), v[dofs].reshape(-1, 4, 2)
        gx, gy, area = p.gx[s], p.gy[s], p.area[s]
        exx = (ue[..., 0] * gx).sum(1)
        eyy = (ue[..., 1] * gy).sum(1)
        exy = 0.5 * ((ue[..., 0] * gy).sum(1) + (ue[..., 1] * gx).sum(1))
        sxx = b1 * (exx + p.nu * eyy)
        syy = b1 * (p.nu * exx + eyy)
        sxy = b1 * (1.0 - p.nu) * exy
        dvol = area * p.thick
        fint = torch.stack([gx * sxx[:, None] + gy * sxy[:, None],
                            gx * sxy[:, None] + gy * syy[:, None]], 2)
        body = (p.dens * dvol / 4.0)[:, None, None] * bforce
        hg = 0.25 * p.dens * p.waves * area.abs().sqrt()
        q = (ve * gamma[None, :, None]).sum(1)                     # (B, 2)
        fhg = -(hg[:, None] * q)[:, None, :] * gamma[None, :, None]
        fe = body - dvol[:, None, None] * fint + fhg
        F.index_add_(0, dofs.reshape(-1), fe.reshape(-1))
    return F


class State(NamedTuple):
    disp: torch.Tensor
    disp_prev: torch.Tensor
    velo: torch.Tensor


def explicit(p: Problem, state: State, nsteps: int, dt: float,
             fext: torch.Tensor, bc: torch.Tensor,
             bforce: torch.Tensor = None) -> State:
    """`nsteps` central-difference steps from `state` under the constant
    point loads fext (n_full,), with homogeneous Dirichlet dofs bc."""
    if bforce is None:
        bforce = torch.zeros(2, dtype=fext.dtype, device=fext.device)
    M = p.mass
    upd = M > 0
    upd[bc] = False
    Msafe = torch.where(M > 0, M, torch.ones_like(M))
    dtt, idtt = dt * dt, 1.0 / (dt * dt)
    u, up, v = state
    zero = torch.zeros_like(u)
    for _ in range(nsteps):
        rhs = fext + residual(p, u, v, bforce) + idtt * M * (2.0 * u - up)
        new = torch.where(upd, dtt * rhs / Msafe, zero)
        v = (new - up) / (2.0 * dt)
        up, u = u, new
    return State(u, up, v)


def critical_step(p: Problem, bc: torch.Tensor, iters: int = 400) -> float:
    """2 / sqrt(largest eigenvalue of M^-1 K) over the free dofs, by power
    iteration (K u = the internal force at rest; the hourglass term reads
    the velocity and adds no stiffness): the central-difference step's
    stability limit."""
    free = torch.ones(p.n_full, dtype=torch.bool, device=p.conn.device)
    free[bc] = False
    zero = torch.zeros(p.n_full, dtype=p.mass.dtype, device=p.conn.device)
    b0 = torch.zeros(2, dtype=p.mass.dtype, device=p.conn.device)
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.rand(p.n_full, generator=g, dtype=p.mass.dtype).to(zero.device)
    lam = 0.0
    for _ in range(iters):
        x = torch.where(free, x, zero)
        x = x / torch.linalg.vector_norm(x)
        y = torch.where(free, -residual(p, x, zero, b0) / p.mass, zero)
        lam = float(torch.dot(x, y))
        x = y
    return 2.0 / math.sqrt(lam)
