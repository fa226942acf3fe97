"""The hand kernels' summed least time over their summed device time in
the traced segment (serve cells)."""

from portbench.layer import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "serve")
