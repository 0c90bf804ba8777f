"""pfemfort_tpu_torch — the PyTorch/CUDA port of pfemfort_tpu.

The JAX package `pfemfort_tpu` is the reference; this package gives the same
answers with PyTorch on the host and the device, and hand-written CUDA
kernels for Hopper (sm_90a) in place of the Pallas TPU kernels.  It imports
neither jax nor any `pfemfort_tpu` module: the numpy-only host modules are
copied here, each naming its source file in its first line.

Ported so far: Poisson and linear elasticity on any mesh through
`solve_poisson` and `solve_elasticity` (nodal point loads; CG, BiCGStab or
GMRES; reduced BCs with Jacobi, Chebyshev, IC(0) or smoothed-aggregation
AMG, or the full system with identity BC rows and Jacobi or geometric
multigrid; float32-inner / float64-outer refinement; matrix-free
Jacobi-CG), the float64 1e-8 box solve `solve/highprec.py:
solve_box_poisson_1e8`, incompressible Navier-Stokes
`cfd.fractional_step_ns`, explicit central-difference dynamics through
`explicit_dynamics` (with checkpoint/resume), mesh partitioning
(`parallel`), the distributed DIA route over torch.distributed ranks
(`drivers.sharded.solve_implicit_sharded`, set up by
`parallel.multihost.initialize`), VTK output, and the command line
`python -m pfemfort_tpu_torch` (`--shards N` included).  Every entry point runs on the card
unless the caller passes device="cpu", and raises without a card.
Generated box_tet and rect_tria Poisson meshes take the structured
slice-add assembly of the reduced DIA system; every other system (read
with `mesh_io`, renumbered, unstructured, ndof > 1) takes the pattern
assembly, first trying a geometric renumbering that recovers a DIA
structure, else solving the ELL system in a bandwidth-reducing row order
(float32 through the hybrid DIA + ELL operator).  Every SpMV on a CUDA
tensor, the preconditioners' own products included, is launched as a
hand-written kernel: csrc/dia_spmv.cu for DIA, csrc/ell_spmv.cu for ELL.
The host loops that are sequential by nature (the ELL pattern, IC(0),
SA aggregation, the partitioners) are host C++ (csrc/host_native.cpp),
built at first use like the kernels.
"""

from pfemfort_tpu_torch.mesh.core import Mesh, ELEMENT_INFO
from pfemfort_tpu_torch.mesh import generate, io as mesh_io
from pfemfort_tpu_torch.dofs.dofmap import DofMap, build_dofmap
from pfemfort_tpu_torch.solve.cg import bicgstab_solve, cg_solve, SolveStats
from pfemfort_tpu_torch.solve.gmres import gmres_solve
from pfemfort_tpu_torch.drivers.poisson import solve_poisson
from pfemfort_tpu_torch.drivers.elasticity import solve_elasticity
from pfemfort_tpu_torch.dynamics.explicit import explicit_dynamics, \
    ExplicitResult

__all__ = [
    "Mesh",
    "ELEMENT_INFO",
    "generate",
    "mesh_io",
    "DofMap",
    "build_dofmap",
    "cg_solve",
    "bicgstab_solve",
    "gmres_solve",
    "SolveStats",
    "solve_poisson",
    "solve_elasticity",
    "explicit_dynamics",
    "ExplicitResult",
]
