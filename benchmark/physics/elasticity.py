"""Physics `elasticity`: 3D linear elasticity on tetra4 under a constant body
force, the configuration's "load" {"bforce": [bx, by, bz]} scaled by a
factor drawn from the seed ({"draw": {"scale": [lo, hi]}}).  The Dirichlet
nodes are clamped in all three components.  Its "material" holds E and nu
(and rho, the explicit loop's density).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import fem

NDOF = 3


def bforce(config: dict, load: dict) -> list:
    return [load["scale"] * v for v in config["load"]["bforce"]]


def dirichlet_rows(traffic, load: dict) -> np.ndarray:
    """(rows, 3) [node, dof, 0] rows, as the reference's files."""
    nodes = traffic.bc_nodes
    rows = np.repeat(nodes, NDOF)
    dofs = np.tile(np.arange(NDOF), len(nodes))
    return np.stack([rows.astype(np.float64), dofs.astype(np.float64),
                     np.zeros(len(rows))], axis=1)


def problem(config: dict, coords: torch.Tensor,
            conn: torch.Tensor) -> fem.Problem:
    mat = config["material"]
    return fem.make_problem("elasticity", coords, conn, E=mat["E"],
                            nu=mat["nu"])


def dirichlet_dofs(traffic, load: dict, p: fem.Problem):
    """(dof ids, zeros) of the clamped nodes, for the reference."""
    dev, dt = p.conn.device, p.geom.vol.dtype
    nodes = torch.as_tensor(traffic.bc_nodes, dtype=torch.int64, device=dev)
    dofs = (nodes[:, None] * NDOF
            + torch.arange(NDOF, device=dev)).reshape(-1)
    return dofs, torch.zeros(dofs.numel(), dtype=dt, device=dev)


def load_vector(traffic, load: dict, p: fem.Problem) -> torch.Tensor:
    """The implicit body-force vector (the implicit driver's carries no
    density)."""
    f = torch.tensor(bforce(traffic.config, load), dtype=p.geom.vol.dtype,
                     device=p.conn.device)
    return fem.nodal_load(p, f)


def solve(traffic, load: dict, **kwargs):
    """The port's implicit driver on a Mesh built anew from the arrays."""
    from pfemfort_tpu_torch import solve_elasticity
    mat = traffic.config["material"]
    return solve_elasticity(traffic.port_mesh(), traffic.dirichlet(load),
                            mat["E"], mat["nu"],
                            bforce=bforce(traffic.config, load),
                            device=traffic.device, **kwargs)
