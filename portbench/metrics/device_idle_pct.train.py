"""Device idle share of the traced segment (train cells)."""

from portbench.layer import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
