"""Physics `poisson`: -div(kappa grad u) = f on tetra4, with the manufactured
solution u = a (x^2 + y^2 + z^2) + b x + c and f = -6 a (kappa = 1), a, b, c
drawn from the seed by the configuration's "load" {"draw": {name: [lo,
hi]}}.  The Dirichlet values are u at the configuration's Dirichlet nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import fem

NDOF = 1


def exact(load: dict, xyz: np.ndarray) -> np.ndarray:
    """The manufactured solution at points xyz (n, 3)."""
    return (load["a"] * (xyz ** 2).sum(1) + load["b"] * xyz[:, 0]
            + load["c"])


def source(load: dict) -> float:
    return -6.0 * load["a"]


def dirichlet_rows(traffic, load: dict) -> np.ndarray:
    """(rows, 3) [node, dof, value] rows, as the reference's files."""
    nodes = traffic.bc_nodes
    vals = exact(load, traffic.mesh_arrays.coords[nodes])
    return np.stack([nodes.astype(np.float64), np.zeros(len(nodes)), vals],
                    axis=1)


def problem(config: dict, coords: torch.Tensor,
            conn: torch.Tensor) -> fem.Problem:
    return fem.make_problem("poisson", coords, conn,
                            kappa=config["material"]["kappa"])


def dirichlet_dofs(traffic, load: dict, p: fem.Problem):
    """(dof ids, values) of the Dirichlet set, for the reference."""
    dev, dt = p.conn.device, p.geom.vol.dtype
    nodes = torch.as_tensor(traffic.bc_nodes, dtype=torch.int64, device=dev)
    xyz = traffic.mesh_arrays.coords[traffic.bc_nodes]
    return nodes, torch.as_tensor(exact(load, xyz), dtype=dt, device=dev)


def load_vector(traffic, load: dict, p: fem.Problem) -> torch.Tensor:
    f = torch.tensor([source(load)], dtype=p.geom.vol.dtype,
                     device=p.conn.device)
    return fem.nodal_load(p, f)


def solve(traffic, load: dict, **kwargs):
    """The port's implicit driver on a Mesh built anew from the arrays."""
    from pfemfort_tpu_torch import solve_poisson
    return solve_poisson(traffic.port_mesh(), traffic.dirichlet(load),
                         kappa=traffic.config["material"]["kappa"],
                         source=source(load), device=traffic.device,
                         **kwargs)
