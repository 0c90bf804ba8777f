"""Plain PyTorch reference of the benchmark's finite-element problems.

It works the physics out again from the mesh arrays and the loads the
benchmark made: linear tetrahedra (tetra4), element by element, with no
assembled matrix, no kernel and nothing of the program under test.

  Poisson      -div(kappa grad u) = f, K_ij = vol sum_d kappa_d dN_i dN_j,
               F_i = vol f / 4 (tetrapoissonparallelimpl1.F).
  Elasticity   sigma = lam tr(eps) I + 2 mu eps, K = vol B^T D B,
               F_(i,c) = vol b_c / 4 (tetraelasticityparallelimpl1.F; the
               implicit body force carries no density).
  Explicit     the residual of ResidualElasticityLinearTetra
               (elementutilitieselasticity3D.F:575-723), 1-point: its
               stress takes the TENSORIAL shear strain 0.5 (du/dy + dv/dx)
               times mu, so the shear stress is half the engineering one;
               F_ext = dens vol b / 4; lumped mass dens vol / 4 per node and
               dof; central differences as tetraelasticityexplicit.F.

Every function takes its dtype from its inputs, so the same code computed in
a lower precision is the benchmark's control.  Element work runs in blocks,
so the reference fits beside nothing else at the benchmark's sizes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BLOCK = 1 << 22   # elements per block of element work


class Geometry(NamedTuple):
    grads: torch.Tensor   # (E, 4, 3) gradients of the barycentric basis
    vol: torch.Tensor     # (E,)


class Problem(NamedTuple):
    """One mesh with its physics, on one device and in one dtype."""
    kind: str             # 'poisson' or 'elasticity'
    conn: torch.Tensor    # (E, 4) int64
    geom: Geometry
    n_node: int
    ndof: int
    kappa: Optional[torch.Tensor] = None   # (3,) Poisson
    lam: float = 0.0                       # elasticity (Lame)
    mu: float = 0.0

    @property
    def n_full(self) -> int:
        return self.n_node * self.ndof


def tet_geometry(x: torch.Tensor) -> Geometry:
    """Basis gradients and volumes of tetrahedra with corners x (E, 4, 3):
    the rows of J^-1, J's columns being the edges from corner 0, by the
    cofactor formula (plain elementwise arithmetic in x's dtype)."""
    a, b, c = (x[:, k] - x[:, 0] for k in (1, 2, 3))       # edges, (E, 3)
    # J^-1 rows: (b x c, c x a, a x b) / det
    r1, r2, r3 = (torch.linalg.cross(b, c), torch.linalg.cross(c, a),
                  torch.linalg.cross(a, b))
    det = (a * r1).sum(1)
    g123 = torch.stack([r1, r2, r3], 1) / det[:, None, None]
    grads = torch.cat([-g123.sum(1, keepdim=True), g123], 1)
    return Geometry(grads, det.abs() / 6.0)


def make_problem(kind: str, coords: torch.Tensor, conn: torch.Tensor, *,
                 kappa=None, E: float = 0.0, nu: float = 0.0) -> Problem:
    """The problem on coords' device and in coords' dtype."""
    conn = conn.to(torch.int64)
    parts = [tet_geometry(coords[conn[s:s + BLOCK]])
             for s in range(0, conn.shape[0], BLOCK)]
    geom = Geometry(torch.cat([p.grads for p in parts]),
                    torch.cat([p.vol for p in parts]))
    if kind == "poisson":
        k = torch.ones(3) if kappa is None else torch.as_tensor(kappa)
        return Problem(kind, conn, geom, coords.shape[0], 1,
                       kappa=k.to(coords.dtype).to(coords.device))
    if kind == "elasticity":
        lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return Problem(kind, conn, geom, coords.shape[0], 3, lam=lam,
                       mu=E / (2.0 * (1.0 + nu)))
    raise ValueError(f"kind={kind!r}")


def _dofs(p: Problem, s: slice) -> torch.Tensor:
    """(B, 4 * ndof) global dof ids of a block of elements, node-major."""
    c = p.conn[s]
    if p.ndof == 1:
        return c
    comp = torch.arange(p.ndof, device=c.device)
    return (c[:, :, None] * p.ndof + comp).reshape(c.shape[0], -1)


def _stress(p: Problem, gu: torch.Tensor, shear: float) -> torch.Tensor:
    """sigma (B, 3, 3) from the displacement gradient gu[b, c, d] =
    d u_c / d x_d; `shear` scales the off-diagonal stresses."""
    sym = gu + gu.transpose(1, 2)
    eye = torch.eye(3, dtype=gu.dtype, device=gu.device)
    tr = gu.diagonal(dim1=1, dim2=2).sum(1)
    off = 1.0 - eye
    return (p.lam * tr[:, None, None] * eye + p.mu * sym * (eye + shear * off))


def apply(p: Problem, u: torch.Tensor, shear: float = 1.0) -> torch.Tensor:
    """K u over the full dof vector (Poisson: the stiffness; elasticity: the
    internal force B^T sigma, with `shear` = 0.5 for the explicit
    residual's tensorial shear)."""
    y = torch.zeros_like(u)
    for s0 in range(0, p.conn.shape[0], BLOCK):
        s = slice(s0, s0 + BLOCK)
        g, vol = p.geom.grads[s], p.geom.vol[s]
        dofs = _dofs(p, s)
        if p.kind == "poisson":
            grad_u = (u[dofs][:, :, None] * g).sum(1) * p.kappa   # (B, 3)
            ye = vol[:, None] * (g * grad_u[:, None, :]).sum(2)     # (B, 4)
        else:
            ue = u[dofs].reshape(-1, 4, 3)                          # [b,i,c]
            gu = (ue[:, :, :, None] * g[:, :, None, :]).sum(1)      # [b,c,d]
            sig = _stress(p, gu, shear)
            ye = vol[:, None, None] * (sig[:, None, :, :]
                                       * g[:, :, None, :]).sum(3)   # [b,i,c]
        y.index_add_(0, dofs.reshape(-1), ye.reshape(-1))
    return y


def diagonal(p: Problem) -> torch.Tensor:
    """The diagonal of K (implicit elasticity: engineering shear)."""
    d = torch.zeros(p.n_full, dtype=p.geom.vol.dtype, device=p.conn.device)
    for s0 in range(0, p.conn.shape[0], BLOCK):
        s = slice(s0, s0 + BLOCK)
        g, vol = p.geom.grads[s], p.geom.vol[s]
        if p.kind == "poisson":
            de = vol[:, None] * (g * g * p.kappa).sum(2)
        else:
            g2 = g * g                                               # [b,i,c]
            de = vol[:, None, None] * ((p.lam + p.mu) * g2
                                       + p.mu * g2.sum(2, keepdim=True))
        d.index_add_(0, _dofs(p, s).reshape(-1), de.reshape(-1))
    return d


def _element_matrices(p: Problem, s: slice) -> torch.Tensor:
    """(B, 4 ndof, 4 ndof) element stiffness of a block of elements."""
    g, vol = p.geom.grads[s], p.geom.vol[s]
    if p.kind == "poisson":
        return vol[:, None, None] * torch.einsum("bid,bjd,d->bij", g, g,
                                                 p.kappa)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    gg = torch.einsum("bid,bjd->bij", g, g)
    # K[(i,c),(j,e)] = vol (lam g_ic g_je + mu (delta_ce g_i.g_j + g_ie g_jc))
    K = (p.lam * torch.einsum("bic,bje->bicje", g, g)
         + p.mu * torch.einsum("bij,ce->bicje", gg, eye)
         + p.mu * torch.einsum("bie,bjc->bicje", g, g))
    return vol[:, None, None] * K.reshape(-1, 12, 12)


def reduced_nonzeros(p: Problem, bc: torch.Tensor, rel_zero: float = 1e-12):
    """(rows, nonzeros, distinct diagonal offsets) of the reduced system
    (free dofs numbered in increasing order): element entries summed by
    (row, column), an entry counted where its sum exceeds rel_zero times the
    largest."""
    dev = p.conn.device
    free = torch.ones(p.n_full, dtype=torch.bool, device=dev)
    free[bc] = False
    n = int(free.sum())
    rank = torch.full((p.n_full,), -1, dtype=torch.int64, device=dev)
    rank[free] = torch.arange(n, device=dev)
    keys, vals = [], []
    for s0 in range(0, p.conn.shape[0], BLOCK):
        s = slice(s0, s0 + BLOCK)
        r = rank[_dofs(p, s)]                                     # (B, nd)
        K = _element_matrices(p, s)
        keep = (r[:, :, None] >= 0) & (r[:, None, :] >= 0)
        keys.append((r[:, :, None] * n + r[:, None, :])[keep])
        vals.append(K[keep])
        del r, K, keep
    keys, vals = torch.cat(keys), torch.cat(vals)
    keys, order = torch.sort(keys)
    vals = vals[order]
    del order
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    del keys
    sums = torch.segment_reduce(vals, "sum", lengths=counts)
    del vals, counts
    nz = sums.abs() > rel_zero * sums.abs().max()
    uniq = uniq[nz]
    offsets = torch.unique(uniq % n - uniq // n)
    return n, int(nz.sum()), int(offsets.numel())


def nodal_load(p: Problem, per_node: torch.Tensor) -> torch.Tensor:
    """F with vol / 4 of the constant `per_node` (ndof,) vector at each
    corner of each element."""
    F = torch.zeros(p.n_full, dtype=p.geom.vol.dtype, device=p.conn.device)
    for s0 in range(0, p.conn.shape[0], BLOCK):
        s = slice(s0, s0 + BLOCK)
        fe = (p.geom.vol[s] / 4.0)[:, None, None] * per_node.reshape(1, 1, -1)
        F.index_add_(0, _dofs(p, s).reshape(-1),
                     fe.expand(-1, 4, -1).reshape(-1))
    return F


def residual_norms(p: Problem, F: torch.Tensor, u: torch.Tensor,
                   bc: torch.Tensor, g: torch.Tensor) -> dict:
    """The norms a solution u (full, with the program's own values at the
    Dirichlet dofs bc) is judged by: the free rows of F - K u, the lifted
    right-hand side (F - K u_D) of the reduced system, F's free rows, and
    the Dirichlet misfit u[bc] - g."""
    free = torch.ones(p.n_full, dtype=torch.bool, device=u.device)
    free[bc] = False
    R = F - apply(p, u)
    uD = torch.zeros_like(u)
    uD[bc] = g
    bD = F - apply(p, uD)
    n = lambda v: float(torch.linalg.vector_norm(v))
    return dict(r_free=n(R[free]), b_reduced=n(bD[free]), f_free=n(F[free]),
                bc_misfit=n(u[bc] - g), g=n(g), u=n(u))


def cg(p: Problem, F: torch.Tensor, bc: torch.Tensor, g: torch.Tensor,
       rtol: float, maxiter: int, check_every: int = 25):
    """Jacobi-preconditioned CG on the reduced system, in F's dtype; returns
    (u full with g at bc, iterations)."""
    free = torch.ones(p.n_full, dtype=torch.bool, device=F.device)
    free[bc] = False
    uD = torch.zeros_like(F)
    uD[bc] = g
    b = (F - apply(p, uD))[free]
    dinv = 1.0 / diagonal(p)[free]

    def A(v):
        w = torch.zeros_like(F)
        w[free] = v
        return apply(p, w)[free]

    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    q = z.clone()
    rz = torch.dot(r, z)
    bn = float(torch.linalg.vector_norm(b.to(torch.float64)))
    k = 0
    while k < maxiter:
        Aq = A(q)
        alpha = rz / torch.dot(q, Aq)
        x += alpha * q
        r -= alpha * Aq
        k += 1
        if k % check_every == 0 and \
                float(torch.linalg.vector_norm(r.to(torch.float64))) \
                <= rtol * bn:
            break
        z = dinv * r
        rz_new = torch.dot(r, z)
        q = z + (rz_new / rz) * q
        rz = rz_new
    u = uD.clone()
    u[free] = x
    return u, k


class State(NamedTuple):
    disp: torch.Tensor
    disp_prev: torch.Tensor
    velo: torch.Tensor


def explicit(p: Problem, state: State, nsteps: int, dt: float, dens: float,
             bforce: torch.Tensor, bc: torch.Tensor) -> State:
    """`nsteps` central-difference steps of the explicit elasticity loop from
    `state`, with homogeneous Dirichlet dofs bc and a constant body force."""
    one = torch.ones(3, dtype=p.geom.vol.dtype, device=p.conn.device)
    M = nodal_load(p, dens * one)
    fext = nodal_load(p, dens * bforce)
    upd = M > 0
    upd[bc] = False
    Msafe = torch.where(M > 0, M, torch.ones_like(M))
    dtt, idtt = dt * dt, 1.0 / (dt * dt)
    u, up, v = state
    for _ in range(nsteps):
        rhs = fext - apply(p, u, shear=0.5) + idtt * M * (2.0 * u - up)
        new = torch.where(upd, dtt * rhs / Msafe, torch.zeros_like(u))
        v = (new - up) / (2.0 * dt)
        up, u = u, new
    return State(u, up, v)
