"""Device kernels in the traced segment per train step."""

from portbench.layer import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "train")
