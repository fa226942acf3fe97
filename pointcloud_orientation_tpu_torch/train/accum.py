"""Gradient accumulation: large effective batches in bounded memory.

Counterpart of ``pointcloud_orientation_tpu/train/accum.py`` on
``torch.autograd``: a global batch is split into ``n_micro`` microbatches
along its first axis, run one after another (``torch.autograd.grad`` frees
each microbatch's graph before the next, so activation memory is that of
one microbatch), their gradients summed and divided by ``n_micro``, and one
optimizer step follows.

For models whose samples do not interact (LayerNorm, no BatchNorm: the
point transformer) the averaged microbatch gradient of a mean loss is the
whole batch's gradient, so the accumulated step equals the whole-batch step
up to the order of the sums. With BatchNorm the statistics become the
microbatches', as in every framework's accumulation.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call


def _split(tree, n_micro: int):
    """``tree`` (a tensor, or a tuple, list or dict of them) as ``n_micro``
    trees of equal slices along the first axis."""
    if torch.is_tensor(tree):
        b = tree.shape[0]
        if b % n_micro:
            raise ValueError(f"batch dim {b} not divisible by n_micro={n_micro}")
        return list(tree.split(b // n_micro))
    if isinstance(tree, dict):
        parts = {k: _split(v, n_micro) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]
    parts = [_split(v, n_micro) for v in tree]
    return [type(tree)(p[i] for p in parts) for i in range(n_micro)]


def accumulated_value_and_grad(loss_fn: Callable, n_micro: int) -> Callable:
    """``value_and_grad`` over ``n_micro`` microbatches run one after another.

    ``loss_fn(params, batch) -> scalar`` must be a mean over the batch
    axis; ``params`` is a dict of tensors that require grad. Returns
    ``vag(params, batch) -> (loss, grads)``, ``grads`` a dict like
    ``params`` (zeros where the loss does not reach a tensor), with loss and
    gradients the microbatches' averages: the whole batch's for mean losses
    on models whose samples do not interact.
    """
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")

    def vag(params: Dict[str, torch.Tensor], batch) -> Tuple[torch.Tensor, Dict]:
        names, leaves = list(params), list(params.values())
        total_loss, total = None, None
        for mb in _split(batch, n_micro):
            loss = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            loss = loss.detach()
            if total is None:
                total_loss, total = loss, grads
            else:
                total_loss = total_loss + loss
                total = [a + g for a, g in zip(total, grads)]
        scale = 1.0 / n_micro
        return total_loss * scale, {n: g * scale for n, g in zip(names, total)}

    return vag


def make_accum_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          n_micro: int, train: bool = False) -> Callable:
    """``step(x, target) -> loss``: the mean squared error of ``model`` on
    ``(x, target)``, its gradient accumulated over ``n_micro`` microbatches
    and left in each parameter's ``.grad``, then one ``optimizer`` step (the
    JAX package's ``make_accum_train_step``, whose ``(params, opt_state)``
    live here in ``model`` and ``optimizer``). ``train`` selects the
    model's train mode for the step (the JAX ``train=``; no random stream
    is passed, so keep it False for a model with dropout). For other
    objectives use :func:`accumulated_value_and_grad` directly."""

    def loss_fn(params, mb):
        x, target = mb
        out = functional_call(model, params, (x,))
        return torch.mean((out - target) ** 2)

    vag = accumulated_value_and_grad(loss_fn, n_micro)

    def step(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.train(train)
        try:
            params = dict(model.named_parameters())
            loss, grads = vag(params, (x, target))
            for name, p in params.items():
                p.grad = grads[name]
            optimizer.step()
        finally:
            model.train(was_training)
        return loss

    return step
