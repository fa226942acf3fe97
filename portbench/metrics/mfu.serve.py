"""The model's products per second over the untraced window, as a share of
the 3xTF32 peak (serve cells)."""

from portbench.layer import mfu


def read(ctx):
    return mfu(ctx, "serve")
