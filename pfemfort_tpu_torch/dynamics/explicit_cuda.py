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

The quad4 hourglass residual (`quad_hg_residual`) is another residual: it
stays in torch on the card and hands its element-minor (ns, E) Fe to the
node pass, whose plan then indexes that layout.

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

from pfemfort_tpu_torch.assembly.assemble import Segments
from pfemfort_tpu_torch.cuda_build import CudaKernel
from pfemfort_tpu_torch.elements.basis import tabulate_basis
from pfemfort_tpu_torch.elements.geometry import grads_and_det

INT32_MAX = 2**31 - 1
_REAL = {torch.float32: ("float", ctypes.c_float),
         torch.float64: ("double", ctypes.c_double)}
_KERNELS: Dict[Tuple[int, int, int, torch.dtype], CudaKernel] = {}


@functools.lru_cache(maxsize=None)
def element_params(npe: int, ndim: int, ngp: int, dtype: torch.dtype):
    """ctypes form of csrc/explicit_step.cu:ElementParams for one build (one
    class a build: ctypes checks an argument's class, not its layout)."""
    real = _REAL[dtype][1]
    voigt = 3 if ndim == 2 else 6

    class ElementParams(ctypes.Structure):
        _fields_ = [("n_elem", ctypes.c_int64), ("dens", real),
                    ("D", real * voigt ** 2), ("N", real * (ngp * npe))]
    return ElementParams


@functools.lru_cache(maxsize=None)
def node_params(dtype: torch.dtype):
    """ctypes form of csrc/explicit_step.cu:NodeParams."""
    real = _REAL[dtype][1]

    class NodeParams(ctypes.Structure):
        _fields_ = [("n_node", ctypes.c_int64), ("cstride", ctypes.c_int64),
                    ("dtt", real), ("idtt", real), ("two_dt", real)]
    return NodeParams


def kernel(npe: int, ndim: int, ngp: int, dtype: torch.dtype) -> CudaKernel:
    """B3's library for one element shape (npe nodes, ndim dimensions, ngp
    Gauss points) and type, made once; it builds at its first launch."""
    key = (npe, ndim, ngp, dtype)
    if key not in _KERNELS:
        if dtype not in _REAL:
            raise TypeError(f"kernel B3 takes float32 or float64, got {dtype}")
        p = ctypes.c_void_p
        _KERNELS[key] = CudaKernel(
            "explicit_step",
            {"explicit_step_element":
                 [p] * 6 + [element_params(npe, ndim, ngp, dtype), p],
             "explicit_step_node": [p] * 10 + [node_params(dtype), p]},
            defines=(f"B3_NPE={npe}", f"B3_NDIM={ndim}", f"B3_NGP={ngp}",
                     f"B3_REAL={_REAL[dtype][0]}"))
    return _KERNELS[key]


class NodePlan(NamedTuple):
    """The node pass's int32 plan: node n's incidences (element, node slot)
    are entries[offsets[n]:offsets[n + 1]], in the stable order of
    `Segments.from_dest`; each entry is the Fe index of the incidence's
    component 0, and component c lies c * cstride further."""
    offsets: torch.Tensor   # (n_node + 1,) int32
    entries: torch.Tensor   # (n_elem * npe,) int32
    cstride: int


def check_int32(n_elem: int, npe: int, ndof: int, n_node: int) -> None:
    """B3 indexes Fe and the plan in int32: raise past it."""
    n_entries = n_elem * npe * ndof
    if n_entries > INT32_MAX or n_node * ndof > INT32_MAX:
        raise ValueError(
            f"kernel B3 indexes in int32: {n_elem} elements x {npe * ndof} "
            f"dofs = {n_entries} entries over {n_node * ndof} dofs is past "
            f"{INT32_MAX}")


def node_plan(seg: Segments, n_elem: int, npe: int, ndof: int, n_node: int,
              element_major: bool = True) -> NodePlan:
    """The node pass's plan from the explicit loop's sorted scatter `seg`
    (`Segments.from_dest` over the element-minor node-dof table: entry
    slot * E + e, slot = i * ndof + c).  A node's components hold the same
    incidences in the same order, so the plan keeps component 0's.
    element_major: index an (E, npe, ndof) Fe (the element pass's), else
    the (npe * ndof, E) Fe of the torch residual (whose component-0 entries
    are seg.perm's own)."""
    check_int32(n_elem, npe, ndof, n_node)
    perm = seg.perm
    slot = torch.div(perm, n_elem, rounding_mode="floor")
    first = perm[slot % ndof == 0]
    if element_major:
        i = torch.div(first, n_elem * ndof, rounding_mode="floor")
        first = ((first - i * n_elem * ndof) * npe + i) * ndof
    offsets = seg.offsets[:n_node * ndof + 1:ndof] // ndof
    return NodePlan(offsets=offsets.to(torch.int32),
                    entries=first.to(torch.int32),
                    cstride=1 if element_major else n_elem)


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
    comp = torch.arange(ndof, device=off.device) * plan.cstride
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

    coords_em: (npe, ndim, E) on the card; conn: (E, npe) the elements'
    node ids in disp (node n's dofs are n * ndof + c); bforce_fn(t) ->
    (ndim,) body force."""

    def __init__(self, coords_em: torch.Tensor, conn: np.ndarray, etype: str,
                 D: np.ndarray, dens: float, thickness: float,
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
        self.conn = torch.as_tensor(
            np.ascontiguousarray(np.asarray(conn).T), device=device
        ).to(torch.int32).contiguous()
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


def _readable(name: str, v: torch.Tensor, dtype: torch.dtype, n: int) -> None:
    """Raise unless a kernel can read v as n contiguous dtype values."""
    if v.dtype != dtype or v.numel() != n or not v.is_contiguous():
        raise ValueError(f"kernel B3: {name} must be {n} contiguous {dtype} "
                         f"values")


class ExplicitStep:
    """B3 for one mesh: `step(disp, disp_prev, velo, t)` -> (new, velo), the
    plain step's contract (dynamics/explicit.py).

    coords_em: (npe, ndim, E) on the card; seg: the loop's sorted scatter;
    fext, free: (n_full,) on the card; mass_em: (ns, E) lumped mass, which
    the step sums in the node pass's order (`mass`, and `upd`, the free
    dofs that have mass); bforce_fn(t) -> (ndim,) body force; residual:
    None for the element pass (`element`), else the torch residual (disp,
    velo, t) -> (ns, E) Fe whose sums the node pass takes."""

    def __init__(self, coords_em: torch.Tensor, conn: np.ndarray, etype: str,
                 seg: Segments, D: np.ndarray, dens: float, thickness: float,
                 fext: torch.Tensor, free: torch.Tensor,
                 mass_em: torch.Tensor, dt: float, bforce_fn: Callable,
                 residual: Optional[Callable] = None):
        dtype, device = coords_em.dtype, coords_em.device
        npe, ndim, n_elem = coords_em.shape
        self.kernel = kernel(npe, ndim, len(tabulate_basis(etype)[1]), dtype)
        self.device, self.dtype, self.ndim = device, dtype, ndim
        self.residual = residual
        n_node = free.numel() // ndim
        self.plan = node_plan(seg, n_elem, npe, ndim, n_node,
                              element_major=residual is None)
        self.mass = ordered_summer(self.plan, ndim)(
            (mass_em.T if residual is None else mass_em)
            .contiguous().reshape(-1))
        self.fext = fext.contiguous()
        self.upd = (free & (self.mass > 0)).to(torch.uint8)
        self.node = node_params(dtype)(n_node,
                                       self.plan.cstride, dt * dt,
                                       1.0 / (dt * dt), 2.0 * dt)
        self.element = None if residual is not None else ElementPass(
            coords_em, conn, etype, D, dens, thickness, bforce_fn,
            free.numel())

    def forces(self, disp: torch.Tensor, velo: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
        """The step's element forces Fe, in the layout the plan indexes: the
        element pass's (E * npe * ndof,), or the torch residual's (ns, E)."""
        if self.residual is not None:
            return self.residual(disp, velo, t).contiguous()
        return self.element(disp, t)

    def update(self, fe: torch.Tensor, disp: torch.Tensor,
               disp_prev: torch.Tensor):
        """The node pass: (u_new, v) from Fe's sums and the state."""
        n = self.fext.numel()
        _readable("fe", fe, self.dtype, self.plan.entries.numel() * self.ndim)
        _readable("disp", disp, self.dtype, n)
        _readable("disp_prev", disp_prev, self.dtype, n)
        new, velo = torch.empty_like(disp), torch.empty_like(disp)
        plan = self.plan
        with torch.cuda.device(self.device):
            self.kernel.launch(
                "explicit_step_node", plan.offsets.data_ptr(),
                plan.entries.data_ptr(), fe.data_ptr(), self.fext.data_ptr(),
                self.mass.data_ptr(), self.upd.data_ptr(), disp.data_ptr(),
                disp_prev.data_ptr(), new.data_ptr(), velo.data_ptr(),
                self.node, torch.cuda.current_stream().cuda_stream)
        return new, velo

    def __call__(self, disp: torch.Tensor, disp_prev: torch.Tensor,
                 velo: torch.Tensor, t: torch.Tensor):
        return self.update(self.forces(disp, velo, t), disp, disp_prev)
