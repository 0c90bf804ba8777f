"""setup_s: process start to the window: the mesh arrays, the loads, the
kernel builds and the warm-up unit on the mesh kind's small mesh."""

UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
