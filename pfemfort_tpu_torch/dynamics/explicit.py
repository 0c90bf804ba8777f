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

The hourglass quad4 (use_hourglass) takes the same step in velocity form,
carrying the half-step velocity w = v^{n-1/2} = (u^n - u^{n-1}) / dt:

  w^{n+1/2} = w^{n-1/2} + dt * (rhs / M)            (rhs without the M term)
  u^{n+1}   = u^n + dt * w^{n+1/2}
  v         = (w^{n-1/2} + w^{n+1/2}) / 2

In exact arithmetic it is the step above.  In float32 it is not: the
displacement form keeps the velocity only as u^{n+1} - u^{n-1}, which
rounds to ulp(u) / dt a step, and the quad program's plate deflects by
tens of thousands of times a step's motion, so its velocities lose most
of their digits within thousands of steps; carried as w they keep their
own.  A
resumed run takes w from the state's u^n - u^{n-1}, so it differs from an
uninterrupted one by that one rounding.  The other shapes keep the
displacement form.

On the card the step is kernel B3 (dynamics/explicit_cuda.py,
csrc/explicit_step.cu): an element pass that forms the residual in
registers from the gathered displacements, and a node pass that sums each
dof's entries in the same fixed order and applies the update; the quad4
hourglass residual has an element pass of its own there, which reads the
velocities too.  A CPU tensor takes the plain step below.

Three things differ from the JAX `lax.scan` on purpose:
  * Determinism.  The mass and the per-step residual are scattered with
    assembly/assemble.py:Segments (destinations sorted once at set-up,
    sorted segments reduced without atomics; on the card B3 sums in the
    same order, its plan sorted on the card from the connectivity), so an
    f32 run repeats bit for bit on the card and a resumed run matches an
    uninterrupted one (in the displacement form; see above).
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
from pfemfort_tpu_torch.dofs.loads import nodal_loads
from pfemfort_tpu_torch.dynamics.explicit_cuda import ExplicitStep
from pfemfort_tpu_torch.elements.elasticity import (
    apply_residual,
    dmat_3d,
    dmat_plane_strain,
    dmat_plane_stress,
    lumped_mass,
    quad_hg_residual,
    quad_hg_viscosity,
    residual_geometry,
)
from pfemfort_tpu_torch.elements.geometry import gather_element_coords
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
    from the call to the first step (the DOF map, the loads, the starting
    state and its two children); inside it explicit.setup.coords_s, the
    connectivity's one copy and the element coordinates gathered through
    it (`gather_element_coords`), and explicit.setup.plan_s, the
    lumped mass and the sums' order with what the step reads (on the card
    B3's node plan from the connectivity, the mass summed in its order and
    the element pass's geometry; on the CPU the sorted scatter of the DOF
    map's node-dof table and the residual's geometry); explicit.loop_s,
    from the first step to the last chunk's probe copy to the host; steps,
    the steps run; explicit.kernel_steps, those of them that ran through
    B3, its node-pass launches (all on the card, none on the CPU);
    explicit.hg_kernel_steps, those whose hourglass residual ran in B3's
    element pass, the hourglass library's element launches (use_hourglass
    on the card; 0 otherwise); explicit.setup_h2d_bytes, the
    bytes of the host arrays the set-up sends to the card (the node
    coordinates, the connectivity, the free mask, the loads, the probe
    ids, a resumed state; 0 on the CPU; the step's scalars and basis
    tables, a few bytes each, are not counted).  The result's own copies
    to the host lie outside every span.
    """
    timings = {}
    with span("explicit.setup_s", timings):
        device = resolve_device(device)
        if dtype is None:
            dtype = torch.get_default_dtype()
        on_card = device.type == "cuda"
        ndim = mesh.ndim
        ndof = ndim
        n_full = mesh.n_node * ndof
        as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

        def send(a, to_dtype=dtype):
            """A host array on `device`, converted on the host first and
            counted as sent to the card."""
            t = torch.as_tensor(a, dtype=to_dtype)
            count("explicit.setup_h2d_bytes", t.nbytes if on_card else 0,
                  timings)
            return t.to(device)

        # the hourglass quad's residual takes the plane-stress D
        D = dmat_plane_stress(E, nu) if use_hourglass else \
            dmat_plane_strain(E, nu) if ndim == 2 else dmat_3d(E, nu)
        with span("explicit.setup.coords_s", timings):
            # the connectivity sent once, as (npe, E) int32: the gather and,
            # on the card, B3's plan and element pass read it
            conn_t = send(mesh.conn, torch.int32).T.contiguous()
            coords_em = gather_element_coords(send(mesh.coords), conn_t)
        # the card needs the free mask alone; the CPU's sorted scatter reads
        # the element-minor node-dof table
        dofmap = build_dofmap(mesh, ndof, dirichlet, with_elem=not on_card)
        free = send(dofmap.free_mask_full(), torch.bool)
        fext = send(nodal_loads(force_bc, mesh.n_node, ndof))

        if bforce_fn is None:
            zero_b = torch.zeros(ndim, dtype=dtype, device=device)
            bforce_fn = lambda t: zero_b

        # the step's scalars as device tensors of the working dtype, as the
        # JAX package's weakly typed Python floats become
        dt_t, dtt, idtt, two_dt = as_dev(dt), as_dev(dt * dt), \
            as_dev(1.0 / (dt * dt)), as_dev(2.0 * dt)
        probe = send(np.asarray(probe_dofs, dtype=np.int64), torch.int64)
        n_probe = probe.numel()

        with span("explicit.setup.plan_s", timings):
            mass_em = lumped_mass(coords_em, mesh.etype, dens, ndof,
                                  ngp=_MASS_NGP[mesh.etype])
            if on_card:
                # B3's plan from conn_t, the mass summed in its order, and
                # the element pass's geometry (the hourglass pass's own)
                step = ExplicitStep(
                    coords_em, conn_t, mesh.etype, D, dens,
                    thickness if ndim == 2 else 1.0, fext, free, mass_em,
                    dt, bforce_fn, hourglass=quad_hg_viscosity(dens)
                    if use_hourglass else None)
                del coords_em, mass_em, conn_t   # B3 keeps what it reads
            else:
                # the node-dof gather table, element-minor (ns, E)
                # flattened: entry (i * ndof + c) * E + e is
                # conn[e, i] * ndof + c; the mass and every step's
                # residual scattered in one sorted order
                dest = torch.as_tensor(
                    dofmap.elem_nodedof.T.reshape(-1).astype(np.int64),
                    device=device)
                ns_e = mesh.npe * ndof, mesh.n_elem
                seg = Segments.from_dest(dest, n_full + 1)
                M_full = seg.sum(mass_em)
                has_mass = M_full > 0
                upd = torch.logical_and(free, has_mass)
                Msafe = torch.where(has_mass, M_full, 1.0)
                if use_hourglass:
                    def residual(disp_full, velo_full, t):
                        return quad_hg_residual(
                            coords_em, disp_full[dest].reshape(ns_e),
                            velo_full[dest].reshape(ns_e), E, nu, dens,
                            bforce_fn(t), thickness=thickness)
                else:
                    geom = residual_geometry(
                        coords_em, mesh.etype,
                        thickness=thickness if ndim == 2 else 1.0)

                    def residual(disp_full, velo_full, t):
                        return apply_residual(
                            geom, disp_full[dest].reshape(ns_e), D, dens,
                            bforce_fn(t))

                # step(disp, carry, velo, t) -> (new, carry, velo): carry
                # is u^{n-1}, or w = v^{n-1/2} in the velocity form
                if use_hourglass:
                    def step(disp, w, velo, t):
                        rhs = seg.sum(residual(disp, velo, t)) + fext
                        w_new = torch.where(upd, w + dt_t * (rhs / Msafe),
                                            0.0)
                        new = torch.where(upd, disp + dt_t * w_new, 0.0)
                        return new, w_new, (w + w_new) * 0.5
                else:
                    def step(disp, disp_prev, velo, t):
                        rhs = seg.sum(residual(disp, velo, t)) + fext
                        rhs = rhs + idtt * M_full * (2.0 * disp - disp_prev)
                        new = torch.where(upd, dtt * rhs / Msafe, 0.0)
                        return new, disp, (new - disp_prev) / two_dt

        if init_state is not None:
            disp, disp_prev, velo = (send(init_state.disp),
                                     send(init_state.disp_prev),
                                     send(init_state.velo))
            start_step = init_state.step
        else:
            disp = torch.zeros(n_full, dtype=dtype, device=device)
            disp_prev, velo = disp.clone(), disp.clone()
        carry = (disp - disp_prev) / dt_t if use_hourglass else disp_prev
        acce = torch.zeros(n_full, dtype=dtype, device=device)

        end_step = start_step + nsteps
        # t_k = k * dt in the working dtype, for every step at once
        t_all = torch.arange(start_step, end_step, device=device).to(dtype) \
            * as_dev(dt)
        snapshots = bool(snapshot_every) and snapshot_cb is not None
        chunk = snapshot_every if snapshots else nsteps
        hist = []
        k0 = start_step
        # B3's launches, counted where they are made (CudaKernel.launch)
        launched = (lambda: dict(step.kernel.entry_launches)) if on_card \
            else dict
        before = launched()
    with span("explicit.loop_s", timings):
        while k0 < end_step:
            kn = min(k0 + chunk, end_step)
            buf = torch.empty((kn - k0, 2 * n_probe), dtype=dtype,
                              device=device)
            for k in range(k0, kn):
                new, carry, velo = step(disp, carry, velo,
                                        t_all[k - start_step])
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
    after = launched()
    ran = lambda entry: after.get(entry, 0) - before.get(entry, 0)
    count("steps", nsteps, timings)
    count("explicit.kernel_steps", ran("explicit_step_node"), timings)
    count("explicit.hg_kernel_steps", ran("explicit_step_element")
          if on_card and step.hourglass else 0, timings)

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
