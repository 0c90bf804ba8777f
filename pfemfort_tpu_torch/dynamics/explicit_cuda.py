"""Hand-written CUDA explicit step (csrc/explicit_step.cu, kernel B3) and
its PyTorch binding.

It replaces no TPU kernel: the JAX package's time loop is a `lax.scan` of
XLA ops, and the port's plain form (dynamics/explicit.py's step on the CPU:
a gather, `apply_residual`, `Segments.sum`, the update) stays beside it for
CPU tensors.  On the card one step is two launches:

* the element pass, one thread an element: the element's displacements
  gathered from the full vector through its int32 node ids, grad u, strain,
  stress and Fe = dens w b - sum_g sum_s dvol B^T sigma in registers, Fe
  written once, element-major (E, npe, ndof);
* the node pass, one thread a dof: its Fe entries summed in the stable
  order `Segments.from_dest` gives (element slot, then element), plus fext,
  and the central-difference update in the same read.

The quad4 hourglass residual (`quad_hg_residual`) has an element pass of
its own (`HourglassPass`, the library built with B3_HG=1): it gathers the
velocities beside the displacements, reads five values of geometry an
element (`quad_hg_geometry`, made once at set-up) and writes Fe as the
other element pass does, so its step is the same two launches.  That
library's node pass takes the update in velocity form (dynamics/explicit.py
says why).

Each (element shape, type) is its own library, built at first use with the
shape's nodes, dimensions and Gauss points as macros (`kernel`);
`CudaKernel.launches` counts a library's launches of both passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.elements.basis import tabulate_basis
from pfemfort_tpu_torch.elements.elasticity import quad_hg_geometry
from pfemfort_tpu_torch.elements.geometry import grads_and_det

INT32_MAX = 2**31 - 1
_REAL = {torch.float32: ("float", ctypes.c_float),
         torch.float64: ("double", ctypes.c_double)}
_KERNELS: Dict[Tuple[int, int, int, torch.dtype, bool], CudaKernel] = {}


def element_params(npe: int, ndim: int, ngp: int, dtype: torch.dtype,
                   hourglass: bool = False):
    """ctypes form of csrc/explicit_step.cu:ElementParams for one build (one
    class a build: ctypes checks an argument's class, not its layout)."""
    return _element_params(npe, ndim, ngp, dtype, bool(hourglass))


@functools.lru_cache(maxsize=None)
def _element_params(npe, ndim, ngp, dtype, hourglass):
    real = _REAL[dtype][1]
    voigt = 3 if ndim == 2 else 6
    tail = [("thick", real), ("hg", real)] if hourglass \
        else [("N", real * (ngp * npe))]

    class ElementParams(ctypes.Structure):
        _fields_ = [("n_elem", ctypes.c_int64), ("dens", real),
                    ("D", real * voigt ** 2)] + tail
    return ElementParams


@functools.lru_cache(maxsize=None)
def node_params(dtype: torch.dtype):
    """ctypes form of csrc/explicit_step.cu:NodeParams."""
    real = _REAL[dtype][1]

    class NodeParams(ctypes.Structure):
        _fields_ = [("n_node", ctypes.c_int64), ("dt", real), ("dtt", real),
                    ("idtt", real), ("two_dt", real)]
    return NodeParams


def kernel(npe: int, ndim: int, ngp: int, dtype: torch.dtype,
           hourglass: bool = False) -> CudaKernel:
    """B3's library for one element shape (npe nodes, ndim dimensions, ngp
    Gauss points) and type, made once; it builds at its first launch.
    hourglass: the 1-point quad4's hourglass pass (B3_HG=1) in place of the
    shape's element pass, and the node pass's update in velocity form."""
    hourglass = bool(hourglass)
    key = (npe, ndim, ngp, dtype, hourglass)
    if key not in _KERNELS:
        if dtype not in _REAL:
            raise TypeError(f"kernel B3 takes float32 or float64, got {dtype}")
        p = ctypes.c_void_p
        _KERNELS[key] = CudaKernel(
            "explicit_step",
            {"explicit_step_element":
                 [p] * 6 + [element_params(npe, ndim, ngp, dtype, hourglass),
                            p],
             "explicit_step_node": [p] * 11 + [node_params(dtype), p]},
            defines=(f"B3_NPE={npe}", f"B3_NDIM={ndim}", f"B3_NGP={ngp}",
                     f"B3_REAL={_REAL[dtype][0]}")
            + (("B3_HG=1",) if hourglass else ()))
    return _KERNELS[key]


class NodePlan(NamedTuple):
    """The node pass's int32 plan: node n's incidences (element, node slot)
    are entries[offsets[n]:offsets[n + 1]], ordered by (slot, element) as
    `Segments.from_dest` orders them; each entry is the index of the
    incidence's component 0 in an element-major (E, npe, ndof) Fe, and
    component c lies c further."""
    offsets: torch.Tensor   # (n_node + 1,) int32
    entries: torch.Tensor   # (n_elem * npe,) int32


def check_int32(n_elem: int, npe: int, ndof: int, n_node: int) -> None:
    """B3 indexes Fe and the plan in int32: raise past it."""
    n_entries = n_elem * npe * ndof
    if n_entries > INT32_MAX or n_node * ndof > INT32_MAX:
        raise ValueError(
            f"kernel B3 indexes in int32: {n_elem} elements x {npe * ndof} "
            f"dofs = {n_entries} entries over {n_node * ndof} dofs is past "
            f"{INT32_MAX}")


def node_plan_from_conn(conn_t: torch.Tensor, n_node: int,
                        ndof: int) -> NodePlan:
    """The node pass's plan from the connectivity alone: conn_t (npe, E)
    int32 node ids on the plan's device.  The explicit loop's sorted
    scatter (`Segments.from_dest` over the element-minor node-dof table,
    entry (i * ndof + c) * E + e) orders a node's component-0 incidences by
    (slot i, element e), and its other components alike; a stable sort by
    node of the slot-major incidences (entry i * E + e) gives that order,
    and the offsets count each node's incidences."""
    npe, n_elem = conn_t.shape
    check_int32(n_elem, npe, ndof, n_node)
    node = conn_t.reshape(-1)
    order = torch.sort(node, stable=True).indices
    i = torch.div(order, n_elem, rounding_mode="floor")
    e = order - i * n_elem
    entries = (e * npe + i) * ndof
    offsets = torch.zeros(n_node + 1, dtype=torch.int64, device=node.device)
    torch.cumsum(torch.bincount(node, minlength=n_node), 0, out=offsets[1:])
    return NodePlan(offsets=offsets.to(torch.int32),
                    entries=entries.to(torch.int32))


def ordered_summer(plan: NodePlan, ndof: int) -> Callable:
    """values -> per-dof sums of the flat `values` (laid out as the plan
    indexes) in the plan's order, one incidence after another from zero:
    the node pass's order, and that of `Segments.sum` on the CPU.  One
    gather a call through a (dofs, most incidences) table whose unused
    slots read a zero past the values, then a column at a time; no host
    sync.  (n_node * ndof,)"""
    off = plan.offsets.long()
    begin, count = off[:-1], off[1:] - off[:-1]
    width = int(count.max()) if count.numel() else 0
    k = torch.arange(width, device=off.device)
    live = k < count[:, None]                               # (n_node, K)
    at = plan.entries.long()[torch.where(live, begin[:, None] + k, 0)]
    comp = torch.arange(ndof, device=off.device)
    n_values = plan.entries.numel() * ndof
    table = torch.where(live[:, None, :], at[:, None, :] + comp[:, None],
                        n_values).reshape(count.numel() * ndof, width)

    def summed(values: torch.Tensor) -> torch.Tensor:
        cols = torch.cat([values, values.new_zeros(1)])[table]
        acc = values.new_zeros(table.shape[0])
        for j in range(width):
            acc = acc + cols[:, j]
        return acc
    return summed


def _isotropic(D: np.ndarray) -> np.ndarray:
    """D as the kernel reads it: a normal block and a shear diagonal; raise
    for an entry outside that pattern."""
    D = np.asarray(D, dtype=np.float64)
    nd = 2 if D.shape[0] == 3 else 3
    pattern = np.zeros(D.shape, dtype=bool)
    pattern[:nd, :nd] = True
    pattern[np.arange(nd, D.shape[0]), np.arange(nd, D.shape[0])] = True
    if np.any(D[~pattern] != 0.0):
        raise ValueError("kernel B3 takes an isotropic D (a normal block and "
                         "a shear diagonal)")
    return D


class ElementPass:
    """B3's element pass for one mesh: `pass_(disp, t)` -> Fe, (E * npe *
    ndof,) element-major, from the full vector disp of n_full values.

    coords_em: (npe, ndim, E) on the card; conn_t: (npe, E) int32 on the
    card, the elements' node ids in disp (node n's dofs are n * ndof + c);
    bforce_fn(t) -> (ndim,) body force."""

    def __init__(self, coords_em: torch.Tensor, conn_t: torch.Tensor,
                 etype: str, D: np.ndarray, dens: float, thickness: float,
                 bforce_fn: Callable, n_full: int):
        dtype, device = coords_em.dtype, coords_em.device
        npe, ndim, n_elem = coords_em.shape
        _, wts, N, dNdu = tabulate_basis(etype)
        ngp = len(wts)
        self.kernel = kernel(npe, ndim, ngp, dtype)
        self.device, self.dtype, self.ndim = device, dtype, ndim
        self.bforce_fn, self.n_full = bforce_fn, n_full
        gradN, det = grads_and_det(coords_em, dNdu)      # (G,d,i,E), (G,E)
        w = torch.as_tensor(wts, dtype=dtype, device=device)
        self.gradN = gradN.contiguous()
        self.dvol = (w[:, None] * det * thickness).contiguous()
        self.conn = _conn_of(conn_t, npe, n_elem, device)
        self.fe = torch.empty(n_elem * npe * ndim, dtype=dtype, device=device)
        Dk = _isotropic(D)
        real = _REAL[dtype][1]
        self.params = element_params(npe, ndim, ngp, dtype)(
            n_elem, dens, (real * Dk.size)(*Dk.reshape(-1)),
            (real * N.size)(*np.asarray(N, dtype=np.float64).reshape(-1)))

    def _bforce(self, t: torch.Tensor) -> torch.Tensor:
        b = torch.as_tensor(self.bforce_fn(t), dtype=self.dtype,
                            device=self.device).contiguous()
        if b.numel() != self.ndim:
            raise ValueError(f"bforce_fn gave {b.numel()} values for "
                             f"{self.ndim} dimensions")
        return b

    def __call__(self, disp: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        _readable("disp", disp, self.dtype, self.n_full)
        b = self._bforce(t)
        with torch.cuda.device(self.device):
            self.kernel.launch(
                "explicit_step_element", self.conn.data_ptr(),
                self.gradN.data_ptr(), self.dvol.data_ptr(), disp.data_ptr(),
                b.data_ptr(), self.fe.data_ptr(), self.params,
                torch.cuda.current_stream().cuda_stream)
        return self.fe


class HourglassPass(ElementPass):
    """B3's hourglass pass for one quad4 mesh: `pass_(disp, velo, t)` -> Fe,
    (E * 8,) element-major, the residual of `quad_hg_residual` from the
    full vectors disp and velo.

    coords_em: (4, 2, E) on the card; conn_t: (4, E) int32 node ids on the
    card; D: the plane-stress matrix; thickness: the residual's; hg: the
    hourglass factor before sqrt|A| (`quad_hg_viscosity`)."""

    def __init__(self, coords_em: torch.Tensor, conn_t: torch.Tensor,
                 D: np.ndarray, dens: float, thickness: float, hg: float,
                 bforce_fn: Callable, n_full: int):
        dtype, device = coords_em.dtype, coords_em.device
        npe, ndim, n_elem = coords_em.shape
        if (npe, ndim) != (4, 2):
            raise ValueError("kernel B3's hourglass pass takes quad4 "
                             f"elements, got {npe} nodes in {ndim}D")
        self.kernel = kernel(4, 2, 1, dtype, hourglass=True)
        self.device, self.dtype, self.ndim = device, dtype, ndim
        self.bforce_fn, self.n_full = bforce_fn, n_full
        g = quad_hg_geometry(coords_em)
        # (a0, a1, c0, c1, area): rows 2 and 3 of dN/dx, dN/dy are -rows 0, 1
        self.geom = torch.stack([g.dNdx[0], g.dNdx[1], g.dNdy[0], g.dNdy[1],
                                 g.area]).contiguous()
        self.conn = _conn_of(conn_t, npe, n_elem, device)
        self.fe = torch.empty(n_elem * 8, dtype=dtype, device=device)
        real = _REAL[dtype][1]
        Dk = np.asarray(D, dtype=np.float64)
        self.params = element_params(4, 2, 1, dtype, True)(
            n_elem, dens, (real * 9)(*Dk.reshape(-1)), thickness, hg)

    def __call__(self, disp: torch.Tensor, velo: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        _readable("disp", disp, self.dtype, self.n_full)
        _readable("velo", velo, self.dtype, self.n_full)
        b = self._bforce(t)
        with torch.cuda.device(self.device):
            self.kernel.launch(
                "explicit_step_element", self.conn.data_ptr(),
                self.geom.data_ptr(), disp.data_ptr(), velo.data_ptr(),
                b.data_ptr(), self.fe.data_ptr(), self.params,
                torch.cuda.current_stream().cuda_stream)
        return self.fe


def _conn_of(conn_t: torch.Tensor, npe: int, n_elem: int,
             device: torch.device) -> torch.Tensor:
    """conn_t as an element pass reads it: (npe, E) int32 on its device;
    raise otherwise."""
    if conn_t.dtype != torch.int32 or conn_t.shape != (npe, n_elem) \
            or conn_t.device != device:
        raise ValueError(f"kernel B3: conn_t must be ({npe}, {n_elem}) "
                         f"int32 node ids on {device}")
    return conn_t.contiguous()


def _readable(name: str, v: torch.Tensor, dtype: torch.dtype, n: int) -> None:
    """Raise unless a kernel can read v as n contiguous dtype values."""
    if v.dtype != dtype or v.numel() != n or not v.is_contiguous():
        raise ValueError(f"kernel B3: {name} must be {n} contiguous {dtype} "
                         f"values")


class ExplicitStep:
    """B3 for one mesh: `step(disp, carry, velo, t)` -> (new, carry, velo),
    the plain step's contract (dynamics/explicit.py): carry is u^{n-1} in
    the displacement form and the half-step velocity v^{n-1/2} in the
    hourglass quad4's velocity form.

    coords_em: (npe, ndim, E) on the card; conn_t: (npe, E) int32 node ids
    on the card, which the node pass's plan (`node_plan_from_conn`) and the
    element pass read; fext, free: (n_full,) on the card; mass_em: (ns, E)
    lumped mass, which the step sums in the node pass's order (`mass`, and
    `upd`, the free dofs that have mass); bforce_fn(t) -> (ndim,) body
    force; hourglass: None for the shape's element pass (`element`), else
    the quad4 hourglass factor (`quad_hg_viscosity`), and then `element` is
    the `HourglassPass` and D the plane-stress matrix."""

    def __init__(self, coords_em: torch.Tensor, conn_t: torch.Tensor,
                 etype: str, D: np.ndarray, dens: float, thickness: float,
                 fext: torch.Tensor, free: torch.Tensor,
                 mass_em: torch.Tensor, dt: float, bforce_fn: Callable,
                 hourglass: Optional[float] = None):
        dtype, device = coords_em.dtype, coords_em.device
        npe, ndim, _ = coords_em.shape
        self.device, self.dtype, self.ndim = device, dtype, ndim
        n_node = free.numel() // ndim
        # the plan and the mass first: their sort and gather temporaries
        # are freed before the element pass allocates what it keeps
        self.plan = node_plan_from_conn(conn_t, n_node, ndim)
        self.mass = ordered_summer(self.plan, ndim)(
            mass_em.T.contiguous().reshape(-1))
        self.fext = fext.contiguous()
        self.upd = (free & (self.mass > 0)).to(torch.uint8)
        self.node = node_params(dtype)(n_node, dt, dt * dt,
                                       1.0 / (dt * dt), 2.0 * dt)
        self.hourglass = hourglass is not None
        if self.hourglass:
            self.element = HourglassPass(coords_em, conn_t, D, dens,
                                         thickness, hourglass, bforce_fn,
                                         free.numel())
        else:
            self.element = ElementPass(coords_em, conn_t, etype, D, dens,
                                       thickness, bforce_fn, free.numel())
        self.kernel = self.element.kernel

    def forces(self, disp: torch.Tensor, velo: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
        """The step's element forces Fe, (E * npe * ndof,) element-major; the
        hourglass pass reads velo too."""
        if self.hourglass:
            return self.element(disp, velo, t)
        return self.element(disp, t)

    def update(self, fe: torch.Tensor, disp: torch.Tensor,
               carry: torch.Tensor):
        """The node pass: (u_new, carry, v) from Fe's sums and the state;
        the displacement form hands disp on as the next carry."""
        n = self.fext.numel()
        _readable("fe", fe, self.dtype, self.plan.entries.numel() * self.ndim)
        _readable("disp", disp, self.dtype, n)
        _readable("carry", carry, self.dtype, n)
        new, velo = torch.empty_like(disp), torch.empty_like(disp)
        carry_new = torch.empty_like(disp) if self.hourglass else disp
        plan = self.plan
        with torch.cuda.device(self.device):
            self.kernel.launch(
                "explicit_step_node", plan.offsets.data_ptr(),
                plan.entries.data_ptr(), fe.data_ptr(), self.fext.data_ptr(),
                self.mass.data_ptr(), self.upd.data_ptr(), disp.data_ptr(),
                carry.data_ptr(), new.data_ptr(),
                carry_new.data_ptr() if self.hourglass else None,
                velo.data_ptr(), self.node,
                torch.cuda.current_stream().cuda_stream)
        return new, carry_new, velo

    def __call__(self, disp: torch.Tensor, carry: torch.Tensor,
                 velo: torch.Tensor, t: torch.Tensor):
        return self.update(self.forces(disp, velo, t), disp, carry)
