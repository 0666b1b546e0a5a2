"""The attention kernels' share (%) of their roofline: the bound of the
enhancer's attention over the real chunks' rows (benchmark/counts/
bs_roformer.py) over the device time of the fused attention kernels."""
from benchmark.harness.reading import roofline


def read(rec):
    return roofline(rec, "attn_bound_ms", "fmha")
