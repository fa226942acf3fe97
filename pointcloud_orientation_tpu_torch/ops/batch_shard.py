"""The rank's slice of a data-parallel batch, seen from inside the model.

The JAX package's data parallelism is global-batch arithmetic: XLA
partitions one program over the sharded batch, so its random draws, its
BatchNorm statistics and its loss are those of the whole batch, and a DP
epoch equals the one-device epoch. A rank of the port holds only its rows.
While a :func:`batch_shard` context is active, the model's batch-shaped
random draws (:func:`draw`: the random centroids, the FPS start points,
the dropout masks) are made at the global batch's shape from the shared
generator and sliced to the rank's rows, and its batch statistics
(:func:`global_mean`: BatchNorm's moments, the MoE router's shares) are
all-reduced over the data group, differentiably, so that the backward
reduces too. Without a context (one device) both are the plain operations.

The shards are equal: ``rank`` holds rows ``[rank * b, (rank + 1) * b)`` of
a global batch of ``world * b`` (the trainer and the predictor pad to
that).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """``rank`` of ``world`` equal shards of the batch over process
    ``group`` (a ``torch.distributed`` group), the mesh axis ``axis``."""

    group: Any
    rank: int
    world: int
    axis: str = "data"

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` (``ValueError`` when
        ``n`` does not divide evenly)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not shard evenly over {self.axis!r} of size "
                             f"{self.world}")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


_CURRENT: Optional[BatchShard] = None


def current() -> Optional[BatchShard]:
    return _CURRENT


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]) -> Iterator[None]:
    """Run the enclosed model calls on ``shard``'s rows (None: one device)."""
    global _CURRENT
    prior, _CURRENT = _CURRENT, shard
    try:
        yield
    finally:
        _CURRENT = prior


def draw(fn: Callable[[Sequence[int]], torch.Tensor], batch: int, *rest: int) -> torch.Tensor:
    """``fn(shape)`` for the rank's ``(batch, *rest)`` rows: drawn at the
    global ``(world * batch, *rest)`` and sliced, so the generator advances
    as on one device and each row gets the numbers it would get there."""
    s = _CURRENT
    if s is None:
        return fn((batch, *rest))
    return fn((s.world * batch, *rest))[s.rank * batch:(s.rank + 1) * batch]


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of ``t``, the mean over the rank's
    rows: all-reduced and divided by the world (equal shards). The
    all-reduce's backward all-reduces the gradient
    (:func:`..parallel.comm.sum_over_group`)."""
    s = _CURRENT
    if s is None:
        return t
    from ..parallel.comm import sum_over_group  # parallel imports the models, which import this

    return sum_over_group(t, s.group) / s.world
