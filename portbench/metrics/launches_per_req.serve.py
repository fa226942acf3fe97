"""Device kernels in the traced segment per request."""

from portbench.layer import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "serve")
