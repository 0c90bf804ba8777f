# Copied from pfemfort_tpu/drivers/presets.py.
"""Hard-coded constants of each reference driver, exposed as presets.

The reference hard-codes material data, time steps and probe DOFs inside each
PROGRAM (SURVEY §5 'Config'); here they are data.  file:line citations point
at the source of each constant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExplicitPreset:
    etype: str
    E: float
    nu: float
    dens: float
    bforce: Tuple[float, ...]
    dt: float
    nsteps: int
    pulse_t: Optional[float] = None   # body-force active for t <= pulse_t
    thickness: float = 1.0
    use_hourglass: bool = False
    # reference probe DOFs are 1-based Fortran indices 671/672 etc.
    probe_dofs: Tuple[int, ...] = ()


# triaelasticityexplicit.F:872-876 (E=200, nu=0.3, rho=10, bforce_x=1 pulse
# t<=0.1), :958-962 (dt=2e-4, 50000 steps), :1098 (probe DOFs 671/672).
TRIA_EXPLICIT = ExplicitPreset(
    etype="tria3", E=200.0, nu=0.3, dens=10.0, bforce=(1.0, 0.0),
    dt=2e-4, nsteps=50000, pulse_t=0.1, probe_dofs=(670, 671))

# quadelasticityexplicit.F:874-879 (E=1e9, nu=0, rho=1000), :954-956
# (dt=1e-5, 20000 steps); hourglass kernel hard-codes thick=0.025
# (elementutilitieselasticity2D.F:734).
QUAD_EXPLICIT = ExplicitPreset(
    etype="quad4", E=1e9, nu=0.0, dens=1000.0, bforce=(0.0, 0.0),
    dt=1e-5, nsteps=20000, thickness=0.025, use_hourglass=True)

# prismelasticityexplicit.F:876-882 (E=2.1e7, nu=0.1, rho=7.6, bforce_x=100),
# :960-962 (dt=2e-5, 40000 steps).
PRISM_EXPLICIT = ExplicitPreset(
    etype="prism6", E=2.1e7, nu=0.1, dens=7.6, bforce=(100.0, 0.0, 0.0),
    dt=2e-5, nsteps=40000)

# elasticityexplicittria6node.F:877-882 (E=1.7e7, nu=0.3, rho=1100,
# bforce_x=3), :957-959 (dt=2e-4, 10000 steps).
TRIA6_EXPLICIT = ExplicitPreset(
    etype="tria6", E=1.7e7, nu=0.3, dens=1100.0, bforce=(3.0, 0.0),
    dt=2e-4, nsteps=10000)

# Implicit elasticity: E=240.565, nu=0.3 (Cook's membrane data;
# triaelasticityparallelimpl1.F:907, tetraelasticityparallelimpl1.F:895-899
# adds rho=1.0, bforce=(0.1,0,0)).  NOTE: the 2D driver leaves elemData(3)
# (thickness) uninitialized — we use 1.0.
IMPLICIT_ELASTICITY_E = 240.565
IMPLICIT_ELASTICITY_NU = 0.3
TETRA_IMPLICIT_BFORCE = (0.1, 0.0, 0.0)
