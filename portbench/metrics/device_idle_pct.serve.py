"""Device idle share of the traced segment (serve cells)."""

from portbench.layer import idle_pct


def read(ctx):
    return idle_pct(ctx, "serve")
