"""Framework utilities of the port: profiling and tracing on
torch.profiler."""
from .profiling import (
    StepTimer, annotate, sync, trace, trace_device_times, trace_top_ops)

__all__ = ["StepTimer", "annotate", "sync", "trace", "trace_device_times",
           "trace_top_ops"]
