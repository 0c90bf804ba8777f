# Ported from pfemfort_tpu/dynamics/explicit.py (single device).
"""Explicit central-difference dynamics with lumped mass (torch).

Redesign of the reference's five explicit drivers
(triaelasticityexplicit.F, quadelasticityexplicit.F,
prismelasticityexplicit.F, elasticityexplicittria6node.F,
tetraelasticityexplicit.F): the 50k-step Fortran time loop is a host loop
whose state never leaves the device.  Each step is a gather -> batched
residual -> ordered segment sum -> state update.  Update formula (central
difference, PFEMFort src/triaelasticityexplicit.F:1072-1085):

  rhs  = F_ext - F_int                              (element residuals)
  rhs += M * (2 u^n - u^{n-1}) / dt^2               (free dofs only)
  u^{n+1}[free] = dt^2 * rhs / M
  v = (u^{n+1} - u^{n-1}) / (2 dt)
  a = (u^{n+1} - 2 u^n + u^{n-1}) / dt^2

Dirichlet BCs are homogeneous (the reference assumes all-zero BC values in
the explicit path; triaelasticityexplicit.F:1060-1062).

Three things differ from the JAX `lax.scan` on purpose:
  * Determinism.  The mass and the per-step residual are scattered with
    assembly/assemble.py:Segments (destinations sorted once at set-up,
    sorted segments reduced without atomics), so an f32 run repeats bit for
    bit on the card and a resumed run matches an uninterrupted one.
  * No per-step host sync.  The probe values go into a preallocated
    (nsteps, 2*n_probe) device buffer that is copied to the host once per
    snapshot chunk (once per run without snapshots); only the last step's
    acceleration is computed.
  * The time of step k is k*dt computed in the working dtype on the device
    (all k at once, as the JAX package's `k.astype(dtype) * dt`), so a pulse
    test such as t <= 0.1 falls on the same side as in JAX.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.dofs.dofmap import build_dofmap
from pfemfort_tpu_torch.elements.elasticity import (
    apply_residual,
    dmat_3d,
    dmat_plane_strain,
    lumped_mass,
    quad_hg_residual,
    residual_geometry,
)
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.mesh.core import Mesh
from pfemfort_tpu_torch.utils.device import resolve_device
from pfemfort_tpu_torch.utils.timing import count, record, span

# Quadrature point counts for the lumped mass, matching each reference mass
# kernel: tria3 1-pt (elasticity2D.F:298), tria6 3-pt (:504), quad4 4-pt
# (:912), prism6 2-pt (elasticity3D.F:177), tetra4 1-pt (the intent of the
# buggy nGP=8 decl at elasticity3D.F:416).
_MASS_NGP = {"tria3": 1, "tria6": 3, "quad4": 4, "prism6": 2, "tetra4": 1,
             "hexa8": 8}


class ExplicitResult(NamedTuple):
    disp: np.ndarray         # (n_node*ndof,) final displacement
    velo: np.ndarray
    acce: np.ndarray
    probe_history: np.ndarray  # (nsteps, n_probe*2) [disp..., velo...]
    times: np.ndarray          # (nsteps,)
    disp_prev: np.ndarray = None  # u^{n-1}, for checkpoint/resume
    timings: dict = None          # explicit.setup_s, explicit.loop_s, steps


def explicit_dynamics(
    mesh: Mesh,
    dirichlet: np.ndarray,
    E: float,
    nu: float,
    dens: float,
    dt: float,
    nsteps: int,
    bforce_fn: Optional[Callable] = None,
    force_bc: Optional[np.ndarray] = None,
    probe_dofs: Sequence[int] = (),
    thickness: float = 1.0,
    use_hourglass: bool = False,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    snapshot_every: int = 0,
    snapshot_cb: Optional[Callable] = None,
    init_state=None,
    start_step: int = 0,
) -> ExplicitResult:
    """Run the central-difference time loop on `device`.

    Args:
      bforce_fn: t -> (ndim,) body-force tensor, where t is a 0-d tensor of
        the working dtype on `device` (use torch.where for pulses like the
        reference's bforce_x = 1 for t <= 0.1,
        triaelasticityexplicit.F:974-977).
      force_bc: optional (n,3) nodal loads applied every step (the quad
        driver's ForceBC path, quadelasticityexplicit.F:1049).
      probe_dofs: global node-dof indices recorded every step (0-based; the
        reference probes DOFs 671/672 1-based).
      use_hourglass: quad4 1-pt + viscous hourglass control
        (ResidualElasticityLinearQuadHG).
      device, dtype: where and in what precision the loop runs; dtype None
        means torch.get_default_dtype().
      snapshot_every/snapshot_cb: host callback cb(step, disp_full) every k
        steps (periodic VTK output in the reference drivers).
      init_state/start_step: resume from a dynamics.checkpoint.ExplicitState
        (run steps [start_step, start_step+nsteps)).
    Timings (host clock, no synchronise of their own): explicit.setup_s,
    from the call to the first step (the DOF map, the element coordinates,
    the sorted scatter, the lumped mass); explicit.loop_s, from the first
    step to the last chunk's probe copy to the host; steps, the steps run.
    The result's own copies to the host lie outside both spans.
    """
    timings = {}
    with span("explicit.setup_s", timings):
        device = resolve_device(device)
        if dtype is None:
            dtype = torch.get_default_dtype()
        ndim = mesh.ndim
        ndof = ndim
        dofmap = build_dofmap(mesh, ndof, dirichlet)
        n_full = mesh.n_node * ndof
        as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

        D = dmat_plane_strain(E, nu) if ndim == 2 else dmat_3d(E, nu)

        coords_em = as_dev(to_element_minor(mesh.elem_coords()))
        # element-minor node-dof gather table (ns, E), flattened; the same
        # destinations, sorted once, scatter every element vector
        dest = torch.as_tensor(
            dofmap.elem_nodedof.T.reshape(-1).astype(np.int64),
            device=device)
        seg = Segments.from_dest(dest, n_full + 1)
        ns_e = dofmap.elem_nodedof.shape[1], mesh.n_elem

        # Lumped mass over the full vector.
        M_full = seg.sum(lumped_mass(coords_em, mesh.etype, dens, ndof,
                                     ngp=_MASS_NGP[mesh.etype]))

        free = torch.as_tensor(dofmap.free_mask_full(), device=device)
        has_mass = M_full > 0
        upd = torch.logical_and(free, has_mass)
        Msafe = torch.where(has_mass, M_full, 1.0)

        fext = np.zeros(n_full, dtype=np.float64)
        if force_bc is not None and len(force_bc):
            idx = (force_bc[:, 0].astype(np.int64) * ndof
                   + force_bc[:, 1].astype(np.int64))
            np.add.at(fext, idx, force_bc[:, 2])
        fext = as_dev(fext)

        if bforce_fn is None:
            zero_b = torch.zeros(ndim, dtype=dtype, device=device)
            bforce_fn = lambda t: zero_b

        # the step's scalars as device tensors of the working dtype, as the
        # JAX package's weakly typed Python floats become
        dtt, idtt, two_dt = as_dev(dt * dt), as_dev(1.0 / (dt * dt)), \
            as_dev(2.0 * dt)
        probe = torch.as_tensor(np.asarray(probe_dofs, dtype=np.int64),
                                device=device)
        n_probe = probe.numel()

        if use_hourglass:
            def residual(disp_full, velo_full, t):
                return quad_hg_residual(
                    coords_em, disp_full[dest].reshape(ns_e),
                    velo_full[dest].reshape(ns_e), E, nu, dens, bforce_fn(t),
                    thickness=thickness)
        else:
            geom = residual_geometry(coords_em, mesh.etype,
                                     thickness=thickness if ndim == 2 else 1.0)

            def residual(disp_full, velo_full, t):
                return apply_residual(geom, disp_full[dest].reshape(ns_e), D,
                                      dens, bforce_fn(t))

        if init_state is not None:
            disp, disp_prev, velo = (as_dev(init_state.disp),
                                     as_dev(init_state.disp_prev),
                                     as_dev(init_state.velo))
            start_step = init_state.step
        else:
            disp = torch.zeros(n_full, dtype=dtype, device=device)
            disp_prev, velo = disp.clone(), disp.clone()
        acce = torch.zeros(n_full, dtype=dtype, device=device)

        end_step = start_step + nsteps
        # t_k = k * dt in the working dtype, for every step at once
        t_all = torch.arange(start_step, end_step, device=device).to(dtype) \
            * as_dev(dt)
        snapshots = bool(snapshot_every) and snapshot_cb is not None
        chunk = snapshot_every if snapshots else nsteps
        hist = []
        k0 = start_step
    with span("explicit.loop_s", timings):
        while k0 < end_step:
            kn = min(k0 + chunk, end_step)
            buf = torch.empty((kn - k0, 2 * n_probe), dtype=dtype,
                              device=device)
            for k in range(k0, kn):
                rhs = seg.sum(residual(disp, velo,
                                       t_all[k - start_step])) + fext
                rhs = rhs + idtt * M_full * (2.0 * disp - disp_prev)
                new = torch.where(upd, dtt * rhs / Msafe, 0.0)
                velo = (new - disp_prev) / two_dt
                if k == end_step - 1:
                    acce = (new - 2.0 * disp + disp_prev) * idtt
                disp_prev, disp = disp, new
                if n_probe:
                    buf[k - k0, :n_probe] = disp[probe]
                    buf[k - k0, n_probe:] = velo[probe]
            hist.append(buf.cpu().numpy())
            if snapshots:
                snapshot_cb(kn, disp.cpu().to(torch.float64).numpy())
            k0 = kn
    count("steps", nsteps, timings)

    host = lambda a: a.cpu().to(torch.float64).numpy()
    res = ExplicitResult(
        disp=host(disp),
        velo=host(velo),
        acce=host(acce),
        probe_history=(np.concatenate(hist) if hist
                       else np.zeros((0, 2 * n_probe))),
        times=np.arange(start_step, end_step, dtype=np.float64) * dt,
        disp_prev=host(disp_prev),
        timings=timings,
    )
    record("explicit_dynamics", timings)
    return res
