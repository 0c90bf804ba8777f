"""Physics `elastodynamics_quad_hg`: the reference's hourglass-controlled
quad4 explicit program (quadelasticityexplicit.F) in plane stress under
point loads (ForceBC) and no body force.

The configuration's "material" holds E, nu, rho, the residual's hard-coded
`thick` and `m_WAVES`; its "load" {"F0", "points", "edge", "component",
"draw": {"f00": [lo, hi], ...}} puts `points` loads, evenly spaced along
the mesh kind's `edge`, each of F0 times its drawn factor in `component`
(1: transverse).  The Dirichlet nodes are clamped in both components.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import quad_hg

NDOF = 2


def dirichlet_rows(traffic, load: dict) -> np.ndarray:
    """(rows, 3) [node, dof, 0] rows, as the reference's files."""
    nodes = traffic.bc_nodes
    rows = np.repeat(nodes, NDOF)
    dofs = np.tile(np.arange(NDOF), len(nodes))
    return np.stack([rows.astype(np.float64), dofs.astype(np.float64),
                     np.zeros(len(rows))], axis=1)


def force_rows(traffic, load: dict) -> np.ndarray:
    """(points, 3) [node, dof, value] ForceBC rows: `points` nodes evenly
    spaced along the loaded edge (all of it where it has fewer), the k-th
    loaded with F0 times the k-th drawn factor (keys in sorted order)."""
    spec = traffic.config["load"]
    edge = traffic.mesh_kind.boundary_nodes(traffic.mesh_arrays, spec["edge"])
    k = min(int(spec["points"]), len(edge))
    nodes = edge[((np.arange(k) + 0.5) * len(edge) / k).astype(np.int64)]
    factors = np.array([load[key] for key in sorted(spec["draw"])][:k])
    return np.stack([nodes.astype(np.float64),
                     np.full(k, float(spec["component"])),
                     spec["F0"] * factors], axis=1)


def problem(config: dict, coords: torch.Tensor,
            conn: torch.Tensor) -> quad_hg.Problem:
    mat = config["material"]
    return quad_hg.make_problem(coords, conn, E=mat["E"], nu=mat["nu"],
                                dens=mat["rho"], thick=mat["thick"],
                                waves=mat["m_WAVES"])


def dirichlet_dofs(traffic, load: dict, p: quad_hg.Problem):
    """(dof ids, zeros) of the clamped nodes, for the reference."""
    dev, dt = p.conn.device, p.mass.dtype
    nodes = torch.as_tensor(traffic.bc_nodes, dtype=torch.int64, device=dev)
    dofs = (nodes[:, None] * NDOF
            + torch.arange(NDOF, device=dev)).reshape(-1)
    return dofs, torch.zeros(dofs.numel(), dtype=dt, device=dev)


def load_vector(traffic, load: dict, p: quad_hg.Problem) -> torch.Tensor:
    """The point loads as a full vector, for the reference."""
    rows = force_rows(traffic, load)
    F = torch.zeros(p.n_full, dtype=p.mass.dtype, device=p.conn.device)
    at = torch.as_tensor(rows[:, 0].astype(np.int64) * NDOF
                         + rows[:, 1].astype(np.int64), device=F.device)
    F.index_put_((at,), torch.as_tensor(rows[:, 2], dtype=F.dtype,
                                        device=F.device), accumulate=True)
    return F
