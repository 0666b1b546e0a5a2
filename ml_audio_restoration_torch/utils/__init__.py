"""Framework utilities of the port: profiling and tracing on
torch.profiler."""
from .profiling import (
    annotate, clear_spans, spans, sync, trace, trace_device_times,
    trace_top_ops)

__all__ = ["annotate", "clear_spans", "spans", "sync", "trace",
           "trace_device_times", "trace_top_ops"]
