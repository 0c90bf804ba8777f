# Copied from pfemfort_tpu/config.py.
"""Configuration layer: solver options with PETSc-options-file parity.

The reference configures its Krylov solver through a PETSc options file
(`PetscInitialize("petsc_options.dat")` + KSPSetFromOptions/PCSetFromOptions;
PFEMFort src/triapoissonparallelimpl1.F:172, solverpetsc.F:198,209),
letting users switch CG <-> BiCGStab <-> GMRES and Jacobi <-> block-Jacobi
without recompiling.  `SolverOptions.from_options_file` reads the same
familiar `-ksp_type cg -pc_type jacobi -ksp_rtol 1e-8` syntax.

Everything the reference hard-codes in driver source (E, nu, rho, dt,
nsteps; SURVEY §5 'Config') is exposed as dataclasses here and in
drivers/presets.py.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Optional

_KSP_ALIASES = {
    "cg": "cg",
    "bcgs": "bicgstab",
    "bicgstab": "bicgstab",
    "gmres": "gmres",
}
_PC_ALIASES = {
    "jacobi": "jacobi",
    "bjacobi": "block_jacobi",
    "block_jacobi": "block_jacobi",
    # PETSc's serial default PC (triapoissonserialimpl1.F:696): the SPD
    # equivalent IC(0) with truncated-Neumann application (solve/ic0.py)
    "ilu": "ic0",
    "icc": "ic0",
    "ic0": "ic0",
    # the options-file AMG escape hatch (solverpetsc.F:1-8): geometric MG
    "hypre": "mg",
    # PETSc gamg IS smoothed aggregation: route to the SA-AMG
    "gamg": "amg",
    "amg": "amg",
    "mg": "mg",
    "none": "none",
}


@dataclasses.dataclass
class SolverOptions:
    ksp_type: str = "cg"          # cg | bicgstab | gmres
    pc_type: str = "jacobi"       # jacobi | block_jacobi | ic0 | amg | mg | none
    rtol: float = 1e-8
    atol: float = 0.0
    max_it: Optional[int] = None
    gmres_restart: int = 30
    refine: bool = False          # mixed-precision iterative refinement

    @classmethod
    def from_options(cls, text: str) -> "SolverOptions":
        """Parse PETSc-style option text: `-ksp_type cg -ksp_rtol 1e-10 ...`.

        Unknown options are ignored (as PETSc does).  Comment lines (#, !)
        are skipped.
        """
        opts = cls()
        tokens = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            tokens.extend(shlex.split(line))
        i = 0
        while i < len(tokens):
            key = tokens[i]
            val = tokens[i + 1] if i + 1 < len(tokens) \
                and not tokens[i + 1].startswith("-") else None
            if key == "-ksp_type" and val:
                opts.ksp_type = _KSP_ALIASES.get(val, opts.ksp_type)
            elif key == "-pc_type" and val:
                opts.pc_type = _PC_ALIASES.get(val, opts.pc_type)
            elif key == "-ksp_rtol" and val:
                opts.rtol = float(val)
            elif key == "-ksp_atol" and val:
                opts.atol = float(val)
            elif key == "-ksp_max_it" and val:
                opts.max_it = int(val)
            elif key == "-ksp_gmres_restart" and val:
                opts.gmres_restart = int(val)
            elif key == "-pfem_refine":
                opts.refine = True
                val = None
            i += 2 if val is not None else 1
        return opts

    @classmethod
    def from_options_file(cls, path: str) -> "SolverOptions":
        with open(path) as f:
            return cls.from_options(f.read())


@dataclasses.dataclass
class Material:
    """Isotropic material data (the reference's elemData(1..6))."""

    E: float = 240.565   # Young's modulus (Cook's membrane preset)
    nu: float = 0.3      # Poisson's ratio
    dens: float = 1.0    # density
    thickness: float = 1.0
    bforce: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class TimeStepping:
    dt: float = 1e-4
    nsteps: int = 1000
    pulse_t: Optional[float] = None
