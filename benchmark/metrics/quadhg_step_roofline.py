"""quadhg_step_roofline: kernel B3's hourglass step (its hourglass element
pass and its node pass, csrc/explicit_step.cu) as a share of the step's
roofline in the traced block: the least time of one step, the bytes its
mathematics needs at the cell's shape and precision (`step_bytes`) over the
H100's data-sheet 3.35 TB/s (harness/peaks.py), divided by B3's device time
a step in the trace.  The steps are the traced block's
explicit.hg_kernel_steps (the program's record of its calls), so the
metric is None where the program keeps no such counter or ran none.  The
card's power limit is printed beside it."""

from benchmark.harness import peaks

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "step_ms", "device_trace"
B3_PASSES = ("element_pass", "node_pass")   # the kernels' names hold these


def step_bytes(traffic) -> int:
    """The least bytes one central-difference step of the hourglass quad4
    program reads and writes: each array its mathematics reads, read once,
    and each it writes, written once.  Read: the int32 connectivity, the
    node coordinates, the state disp, the half-step velocity w and velo
    (the program's velocity form, whose w takes the place of the
    displacement form's disp_prev), the lumped mass (one value a node:
    both components share it), the point loads as their ForceBC rows (an
    int32 node id and a value each) and the free mask (a byte a dof);
    written: the new disp, w and velo.  Nothing an implementation stages
    between passes counts, so a split step and a fused one need the
    same."""
    m = traffic.mesh_arrays
    n_elem, npe = m.conn.shape
    n_node, ndim = m.coords.shape
    n_full = n_node * ndim
    size = traffic.dtype.itemsize
    points = int(traffic.config["load"]["points"])
    read = 4 * n_elem * npe + n_node * ndim * size + 3 * n_full * size \
        + n_node * size + points * (4 + size) + n_full
    return read + 3 * n_full * size


def step_flops(traffic) -> int:
    """Floating-point operations of one step as the plain formulas count
    them: an element's strain (four 4-term dot products and the shear's
    add and half, 30), stress (10), dvol, body force and hourglass factor
    (8), hourglass sums (10) and its 8 forces (48): 106; a dof's sum of its
    element entries (E * npe incidences a component in all) and its update
    (10).  At 1.1e9 a step of the cell, ~17 us at the data sheet's float32
    67 TFLOP/s against 195 us of least bytes: the step is bound by memory,
    which is why the roofline is a share of the bandwidth."""
    m = traffic.mesh_arrays
    n_elem, npe = m.conn.shape
    n_full = m.coords.size
    return 106 * n_elem + n_elem * npe * m.coords.shape[1] + 10 * n_full


def traced_hg_steps(run) -> int:
    """explicit.hg_kernel_steps of the traced block: the last profiled
    explicit_dynamics record; 0 where there is none or no such counter."""
    from pfemfort_tpu_torch.utils import timing
    recs = [r.timings for r in getattr(timing, "RECENT", ())
            if r.name == "explicit_dynamics" and r.profiled]
    return int(recs[-1].get("explicit.hg_kernel_steps", 0)) if recs else 0


def read(run):
    if run.trace is None:
        return None
    steps = traced_hg_steps(run)
    seconds = sum(run.trace.device_seconds(k)[0] for k in B3_PASSES)
    if not steps or seconds <= 0:
        return None
    least = step_bytes(run.traffic) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / (seconds / steps)
