"""peak_gib: the card's peak allocated memory over the window,
torch.cuda.max_memory_allocated, in GiB."""

UNIT, SOURCE = "GiB", "host_clock"


def read(run):
    return run.peak_bytes / 2 ** 30
