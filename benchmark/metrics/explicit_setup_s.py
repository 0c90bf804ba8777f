"""explicit_setup_s: the mean over the window's blocks of the program's span
explicit.setup_s: explicit_dynamics from its call to its first step (the
DOF map, the element coordinates, the sorted scatter, the lumped mass),
which each resumed block runs again.

The explicit entry keeps no timings, so this reads the program's record of
its recent calls (pfemfort_tpu_torch.utils.timing.RECENT): the
explicit_dynamics records made with no profiler running whose steps are
the mix's block_steps, the last as many as the window has blocks.  That
leaves out the warm-up (its warm_steps) and the traced block (profiled).
None where the program keeps no such record."""

UNIT, LAYER, MOVES, SOURCE = "s", "time loop", "step_ms", "program_span"


def window_records(run):
    """The timings of the window's blocks, from the program's records."""
    from pfemfort_tpu_torch.utils import timing
    block = run.traffic.mix["block_steps"]
    recs = [r.timings for r in getattr(timing, "RECENT", ())
            if r.name == "explicit_dynamics" and not r.profiled
            and r.timings.get("steps") == block]
    n = sum(1 for u in run.units if u.get("steps") == block)
    return recs[-n:] if n else []


def read(run):
    t = window_records(run)
    return sum(x["explicit.setup_s"] for x in t) / len(t) if t else None
