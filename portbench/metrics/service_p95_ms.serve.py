"""95th percentile of a request's service time (call to numpy result) in
the untraced window (serve cells: above the knee the wait from the time a
request fell due grows all through the run, so it is no steady tail)."""

from portbench.layer import service_p95_ms


def read(ctx):
    return service_p95_ms(ctx)
