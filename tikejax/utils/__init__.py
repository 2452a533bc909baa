"""Utilities: host IO, checkpointing, metrics."""

from tikejax.utils.hostio import (cfull, cones, czeros, scalar, to_device,
                                  to_host)
from tikejax.utils.profiling import (Timer, device_sync, summarize_metrics,
                                     trace)

__all__ = ["to_host", "to_device", "scalar", "cfull", "cones", "czeros",
           "Timer", "trace", "summarize_metrics", "device_sync"]
