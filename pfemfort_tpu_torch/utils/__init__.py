from pfemfort_tpu_torch.utils.device import resolve_device
from pfemfort_tpu_torch.utils.timing import Timer, timed

__all__ = ["Timer", "timed", "resolve_device"]
