"""Device ms a traced restore in the elementwise bucket (ATen)."""
from benchmark.harness.reading import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec, "fusion(elementwise)")
