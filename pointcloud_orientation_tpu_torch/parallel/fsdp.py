"""Fully-sharded data parallelism (ZeRO-3) for any model of the zoo.

Counterpart of ``pointcloud_orientation_tpu/parallel/fsdp.py``. Every
parameter large enough, and so its optimizer state, is split over the
``data`` axis: a rank holds ``1/n`` of it; before use the shards are
all-gathered, and the backward reduce-scatters the gradient, so each rank
receives the global gradient of its own shard and its optimizer updates
only that (:func:`.comm.gather_from_group`). The batch stays data-parallel
on the same axis. The JAX package lets XLA insert these collectives from a
``PartitionSpec`` a leaf; the port writes them out, with the same specs.

The spec rule (:func:`fsdp_param_specs`) is decided on the flax layout of
each leaf (``utils/jax_weights.py``'s pairing), so the same logical
dimension is split as in the JAX package: an ``nn.Linear`` weight is the
flax kernel transposed, and the tie rule would otherwise pick the other
dimension. A rank's shard is a block of the leaf in that layout.

In train mode the model's batch-shaped draws and BatchNorm statistics are
the global batch's (:mod:`..ops.batch_shard`), as in the data-parallel
``Trainer``; BatchNorm's running statistics are buffers, updated alike on
every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.batch_shard import batch_shard
from .comm import all_reduce_grads, gather_from_group
from .mesh import batch_sharding, map_tree


def fsdp_spec(shape, axis_size: int, axis: str = "data", min_weight_size: int = 1024) -> tuple:
    """A leaf's spec: its largest dimension divisible by ``axis_size``
    (ties to the trailing one) split over ``axis``, or ``()`` (replicated)
    for a leaf under ``min_weight_size`` elements or with no divisible
    dimension."""
    shape = tuple(int(n) for n in shape)
    size = 1
    for n in shape:
        size *= n
    if not shape or size < min_weight_size:
        return ()
    divisible = [d for d, n in enumerate(shape) if n % axis_size == 0]
    if not divisible:
        return ()
    best = max(divisible, key=lambda d: (shape[d], d))
    return tuple(axis if d == best else None for d in range(len(shape)))


def fsdp_param_specs(params, axis_size: int, axis: str = "data", min_weight_size: int = 1024,
                     skip=None):
    """The spec tree of a flax ``params`` tree (nested dicts of arrays or
    tensors; a meta tensor stands for a shape): a tuple a leaf, as
    ``tuple(PartitionSpec)`` (``()`` replicated, else one entry a
    dimension, ``axis`` on the split one).
    ``skip``: a like-structured spec tree (e.g. :func:`.tp.tp_param_specs`);
    a leaf with a non-empty skip spec keeps it."""

    def spec_for(path, leaf, prior=None):
        if prior is not None and tuple(prior) != ():
            return tuple(prior)
        return fsdp_spec(leaf.shape, axis_size, axis, min_weight_size)

    if skip is None:
        return map_tree(spec_for, params)
    return map_tree(spec_for, params, skip)


class FSDPParams(nn.Module):
    """The rank's shards of ``model``'s parameters, each in its flax layout
    (a block along the split dimension, or the whole leaf when it is
    replicated); ``model`` keeps its structure and buffers and is run with
    the gathered weights (:meth:`gathered`)."""

    def __init__(self, model: nn.Module, mesh, axis: str = "data", min_weight_size: int = 1024,
                 skip=None):
        from ..utils.jax_weights import flax_parameter_paths, to_flax_layout

        super().__init__()
        shard = batch_sharding(mesh, axis)
        self.group, self.rank, self.world = shard.group, shard.rank, shard.world
        self.model = [model]  # held, not registered: its parameters are not this module's
        paths = flax_parameter_paths(model)
        shapes: Dict = {}
        for name, (path, shape, _) in paths.items():
            node = shapes
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = torch.empty(shape, device="meta")
        specs = fsdp_param_specs(shapes, self.world, axis, min_weight_size, skip)
        self.layout: Dict[str, Any] = {}
        self.shards = nn.ParameterDict()
        for name, p in model.named_parameters():
            path, shape, kind = paths[name]
            spec = specs
            for key in path:
                spec = spec[key]
            dim = spec.index(axis) if axis in spec else None
            full = to_flax_layout(p.detach(), shape, kind)
            local = full if dim is None else torch.chunk(full, self.world, dim)[self.rank]
            key = name.replace(".", "/")
            self.shards[key] = nn.Parameter(local.clone().contiguous())
            self.layout[key] = (name, tuple(p.shape), kind, dim)

    def gathered(self) -> Dict[str, torch.Tensor]:
        """The full weights by parameter name, gathered (differentiably:
        the backward reduce-scatters) from the shards."""
        from ..utils.jax_weights import from_flax_layout

        out = {}
        for key, shard in self.shards.items():
            name, shape, kind, dim = self.layout[key]
            full = shard if dim is None else gather_from_group(shard, self.group, dim)
            out[name] = from_flax_layout(full, shape, kind)
        return out

    def replicated(self):
        """The shards that hold a whole leaf (their gradients are summed
        over the axis)."""
        return [p for key, p in self.shards.items() if self.layout[key][3] is None]

    def unshard(self) -> nn.Module:
        """``model`` with the gathered weights copied in (every rank calls it)."""
        model = self.model[0]
        with torch.no_grad():
            full = self.gathered()
            for name, p in model.named_parameters():
                p.copy_(full[name])
        return model


def shard_fsdp_params(model: nn.Module, mesh, axis: str = "data", min_weight_size: int = 1024,
                      skip=None) -> FSDPParams:
    """``model``'s weights split over ``axis`` of ``mesh`` under
    :func:`fsdp_param_specs` (every rank holds the same ``model``)."""
    return FSDPParams(model, mesh, axis, min_weight_size, skip)


def make_fsdp_train_step(model: nn.Module, mesh, axis: str = "data", train: bool = False,
                         remat: bool = False):
    """``step(params, opt, x, target, generator=None) -> (params, opt,
    loss)``, in place: ``params`` from :func:`shard_fsdp_params`, ``opt``
    an optimizer over ``params.parameters()`` (so its state is the
    shards'; the JAX step's ``tx``), ``x (B/n, N,
    C)``/``target (B/n, 3)`` the rank's rows. The loss is the mean squared
    error over the global batch; the shards' gradients come back
    reduce-scattered, the replicated leaves' summed. ``remat=True``
    recomputes the forward (and so regathers the weights) in the
    backward, drawing the same masks and leaving the running statistics
    as one forward leaves them. ``train=True`` runs the model in train
    mode and needs ``generator`` (the JAX ``ValueError``)."""
    sharding = batch_sharding(mesh, axis)

    def step(params: FSDPParams, opt, x, target, generator: Optional[torch.Generator] = None):
        if train and generator is None:
            raise ValueError("make_fsdp_train_step(train=True) requires step(..., generator=...) "
                             "for the dropout masks")
        model.train(train)
        state = None if generator is None else generator.get_state()
        buffers = [b for b in model.buffers()]
        calls = [0]

        def fwd(x):
            saved = [b.clone() for b in buffers] if calls[0] else None
            calls[0] += 1
            if generator is not None:
                generator.set_state(state)
            with batch_shard(sharding):
                out = functional_call(model, params.gathered(), (x, generator))
            if saved is not None:  # the recompute: the running statistics stay the forward's
                with torch.no_grad():
                    for b, s in zip(buffers, saved):
                        b.copy_(s)
            return out

        out = checkpoint(fwd, x, use_reentrant=False) if remat else fwd(x)
        local = ((out - target) ** 2).sum() / (out.numel() * sharding.world)
        opt.zero_grad(set_to_none=True)
        local.backward()
        all_reduce_grads(params.replicated(), sharding.group)
        opt.step()
        loss = local.detach().clone()
        torch.distributed.all_reduce(loss, group=sharding.group)
        return params, opt, loss

    return step
