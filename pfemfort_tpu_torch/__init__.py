"""pfemfort_tpu_torch — the PyTorch/CUDA port of pfemfort_tpu.

The JAX package `pfemfort_tpu` is the reference; this package gives the same
answers with PyTorch on the host and the device, and hand-written CUDA
kernels for Hopper (sm_90a) in place of the Pallas TPU kernels.  It imports
neither jax nor any `pfemfort_tpu` module: the numpy-only host modules are
copied here, each naming its source file in its first line.

The slice ported so far is the flagship main path (tetrapoissonparallelimpl1):
box_tet mesh -> DOF map -> tetra4 Poisson element matrices -> structured
slice-add assembly of the reduced DIA system -> Jacobi-CG, with every SpMV
on a CUDA tensor launched as the kernel in csrc/dia_spmv.cu.
"""

from pfemfort_tpu_torch.mesh.core import Mesh, ELEMENT_INFO
from pfemfort_tpu_torch.mesh import generate
from pfemfort_tpu_torch.dofs.dofmap import DofMap, build_dofmap
from pfemfort_tpu_torch.solve.cg import cg_solve, SolveStats
from pfemfort_tpu_torch.drivers.poisson import solve_poisson

__all__ = [
    "Mesh",
    "ELEMENT_INFO",
    "generate",
    "DofMap",
    "build_dofmap",
    "cg_solve",
    "SolveStats",
    "solve_poisson",
]
