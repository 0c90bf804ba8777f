# Ported from pfemfort_tpu/solve/matfree.py.
"""Matrix-free CG: assembly-free operator application.

y = A x computed per CG iteration as gather -> batched element apply ->
ordered segment sum, never materialising the global matrix.  Trades
arithmetic for memory: the only persistent state is the element geometry
(gradN, dvol) and the sorted scatter — the mode for meshes whose assembled
matrix would not fit the card.  The reference's drivers recompute K_e on
every solve the same way, minus the MatSetValues.

The scatter is the assembly's `Segments` (assembly/assemble.py): the
destinations are sorted once here and every product reduces the sorted
segments without atomics, so a float32 solve repeats bit for bit on the
card (never `index_add_`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dofs.dofmap import DofMap
from pfemfort_tpu_torch.elements.basis import tabulate_basis
from pfemfort_tpu_torch.elements.geometry import grads_and_det
from pfemfort_tpu_torch.elements.poisson import poisson_matfree_apply


class PoissonMatfree:
    """The persistent state of a matrix-free Poisson operator: the element
    geometry, the gather of the reduced dofs and their sorted scatter."""

    def __init__(self, coords_em: torch.Tensor, etype: str, dofmap: DofMap,
                 kappa=None, af: float = 1.0, ngp: Optional[int] = None):
        dtype, device = coords_em.dtype, coords_em.device
        _, wts, _, dNdu = tabulate_basis(etype, ngp)
        ndim = dNdu.shape[1]
        if kappa is None:
            kappa = np.ones(ndim)
        self.kappa = torch.as_tensor(np.asarray(kappa, np.float64),
                                     dtype=dtype, device=device)
        self.af = af
        self.gradN, det = grads_and_det(coords_em, dNdu)   # (G,d,npe,E)
        self.dvol = torch.as_tensor(wts, dtype=dtype, device=device)[:, None] \
            * det
        self.n = n = dofmap.total_dof
        # (npe, E) reduced dof per element slot, -1 -> the zero slot n
        ed_t = dofmap.elem_dof.T.astype(np.int64)
        self.gather_idx = torch.as_tensor(np.where(ed_t < 0, n, ed_t),
                                          device=device)
        self.segments = Segments.from_dest(self.gather_idx.reshape(-1), n + 1)

    def element_apply(self, u_e: torch.Tensor) -> torch.Tensor:
        """K_e u_e for every element, (npe, E)."""
        return poisson_matfree_apply(u_e, self.gradN, self.dvol, self.kappa,
                                     af=self.af)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xp = torch.cat([x, x.new_zeros(1)])
        return self.segments.sum(self.element_apply(xp[self.gather_idx]))

    def diagonal(self) -> torch.Tensor:
        """diag(A) on the free dofs: sum_e dvol kappa_d gradN_di^2."""
        G, pdim = self.gradN.shape[:2]
        diag_e = sum(self.dvol[g] * self.kappa[d] * self.gradN[g, d]
                     * self.gradN[g, d]
                     for g in range(G) for d in range(pdim)) * self.af
        return self.segments.sum(diag_e)


def make_poisson_matfree_operator(
    coords_em: torch.Tensor,
    etype: str,
    dofmap: DofMap,
    kappa=None,
    af: float = 1.0,
    ngp: Optional[int] = None,
) -> Tuple[Callable, torch.Tensor]:
    """(operator, diag) of the reduced Poisson system, matrix-free, on
    coords_em's device and in its dtype.

    The reduced <-> element mapping uses elem_dof with the -1 sentinel
    routed to a zero-padded slot, exactly like the assembled path's
    scatter plans."""
    op = PoissonMatfree(coords_em, etype, dofmap, kappa=kappa, af=af,
                        ngp=ngp)
    return op, op.diagonal()
