"""The hand kernels' summed least time over their summed device time in
the traced segment (train cells)."""

from portbench.layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train")
