"""The mixture-of-experts feed-forward of the MoE point transformer, and its
experts sharded over ranks.

Counterpart of ``pointcloud_orientation_tpu/parallel/ep.py``: :class:`MoEFeedForward`
(top-1 softmax routing, the switch load-balance auxiliary loss) and its two
dispatches, written as the JAX package writes them:

``"masked"`` (:func:`expert_compute`) runs every expert over every token,
``(B, N, K, F)`` hidden activations, and keeps each token's own expert by
its one-hot; ``"capacity"`` (:func:`expert_compute_capacity`) gives each
expert ``C = expert_capacity(T, K, factor)`` slots, places the tokens by a
cumulative count in the flattened ``B*N`` order, drops those past an
expert's capacity (exact zero output) and runs ``K*C`` slots of FFN work.
At ``capacity_factor >= n_experts`` no token drops and both agree.

The experts' parameters are stacked on a leading expert axis, ``wi (K, E,
F)``, ``bi (K, F)``, ``wo (K, F, E)``, ``bo (K, E)``, as flax's tree holds
them; the router is a Dense without bias. The module takes no compute type:
a bf16 input is promoted against the f32 parameters, as flax's ``Dense``
and ``jnp.einsum`` promote it, so the FFN computes in f32 on bf16-rounded
inputs and returns f32. The products are cuBLAS's (``torch.einsum``,
``torch.bmm``; the JAX package's einsums have no Pallas body).

Expert parallelism (:func:`make_ep_apply`, :func:`place_ep_params`): a rank
of the mesh's ``expert`` axis holds ``K/n`` consecutive experts and the
whole router; every rank routes the whole token set (the router is small),
runs only its experts (either dispatch: the capacity slots are laid out on
the global assignment and cut to the rank's experts), and the partial
outputs are all-reduced (forward all-reduce, identity backward; the input
reaches the experts through an identity whose backward all-reduces,
:mod:`.comm`). The auxiliary loss is the one-device one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.batch_shard import current, global_mean
from .comm import all_gather_cat

DISPATCHES = ("masked", "capacity")


def expert_capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Static per-expert slot count: ``ceil(T/K * factor)`` rounded up to a
    multiple of 8, as the JAX package computes it. At ``factor >=
    n_experts`` it is at least T, so no token can drop."""
    cap = -(-n_tokens * capacity_factor // n_experts)  # ceil
    return int(-(-cap // 8) * 8)


def expert_compute(x: torch.Tensor, onehot: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
                   wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """Masked dense dispatch: ``h_k = relu(x @ wi_k + bi_k)``, ``y = sum_k
    onehot_k * (h_k @ wo_k + bo_k)`` over ``x (B, N, E)``."""
    h = torch.relu(torch.einsum("bne,kef->bnkf", x, wi) + bi)  # (B, N, K, F)
    y = torch.einsum("bnkf,kfe->bnke", h, wo) + bo  # (B, N, K, E)
    return torch.einsum("bnke,bnk->bne", y, onehot.to(y.dtype))


def slot_tokens(assign: torch.Tensor, n_experts: int, capacity: int,
                before: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(K, C)`` token index of each expert slot, ``T = assign.numel()``
    (the sentinel) where a slot is empty. A token's slot in its expert is
    the count of the tokens routed there before it in the flattened order;
    tokens at or past ``capacity`` get none. ``before (K,)``: the tokens
    that precede this shard in the global order and go to each expert
    (:func:`tokens_before`); a token then keeps its slot only while its
    global place ``before[k] + slot`` is below ``capacity``, so the shard
    keeps exactly its tokens of the global layout. Tokens that get no slot are
    written to one spare slot that is cut off, so every kept slot is written
    at most once: the result is deterministic on any device, with no
    host sync. The count runs along the token axis of a ``(K, T)`` one-hot,
    contiguous in T: a scan over the outer axis of ``(T, K)`` (the JAX
    package's layout) takes a thread a column, four threads for T
    tokens."""
    a = assign.reshape(-1)
    T = a.numel()
    onehot = (a[None, :] == torch.arange(n_experts, device=a.device)[:, None]).long()
    pos = torch.gather(onehot.cumsum(1), 0, a[None, :])[0] - 1  # (T,) place within its expert
    place = pos if before is None else pos + before[a]
    flat = torch.where(place < capacity, a * capacity + pos,
                       torch.full_like(a, n_experts * capacity))
    slots = torch.full((n_experts * capacity + 1,), T, dtype=torch.long, device=a.device)
    slots[flat] = torch.arange(T, device=a.device)
    return slots[:-1].reshape(n_experts, capacity)


def tokens_before(assign: torch.Tensor, n_experts: int, shard) -> torch.Tensor:
    """``(K,)`` the tokens that the data ranks below ``shard.rank`` route to
    each expert: every rank's per-expert counts gathered over the data
    group (integers, no gradient), the lower ranks' summed. Rank ``r``
    holds rows ``[r*b, (r+1)*b)`` of the global batch, so these tokens come
    before the rank's own in the global flattened order."""
    counts = torch.bincount(assign.reshape(-1), minlength=n_experts)
    every = all_gather_cat(counts, shard.group).reshape(shard.world, n_experts)
    return every[:shard.rank].sum(0)


def expert_compute_capacity(x: torch.Tensor, assign: torch.Tensor, wi: torch.Tensor,
                            bi: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                            capacity: int, first_expert: int = 0,
                            n_experts: Optional[int] = None,
                            before: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch-style gather dispatch over ``x (B, N, E)``: each expert's
    ``capacity`` slots (:func:`slot_tokens`) gather their tokens' rows (the
    zero row ``T`` for an empty slot), run the expert's FFN, and their
    outputs go back to their tokens' rows. Each token owns at most one
    slot, so the combine writes unique rows (the JAX package's scatter-add
    over them); the empty slots' bias-only outputs all land in row ``T``,
    which is cut off. A dropped token's output is exactly zero. The gather
    is an ``index_select``, whose backward adds each slot's gradient to its
    row with atomics: a real row receives one addition, so its value does
    not depend on their order, and the many empty slots' additions go to
    the cut-off row (the sort-based backward of an advanced-index gather
    serialises that row's duplicates). ``first_expert``/``n_experts``:
    ``wi``... hold the experts ``[first_expert, first_expert + K_local)``
    of ``n_experts``; the slots are laid out on the global assignment, as
    unsharded, and cut to those experts. ``before``: ``x`` is a data
    rank's shard of the batch, and its tokens keep their slots of the
    global batch's layout (:func:`slot_tokens`)."""
    B, N, E = x.shape
    K = wi.shape[0]
    T = B * N
    slots = slot_tokens(assign, n_experts or K, capacity, before)[first_expert:first_expert + K]
    x_pad = torch.cat([x.reshape(T, E), x.new_zeros((1, E))], dim=0)
    xg = torch.index_select(x_pad, 0, slots.reshape(-1)).reshape(K, capacity, E)
    h = torch.relu(torch.bmm(xg, wi) + bi[:, None, :])
    yg = torch.bmm(h, wo) + bo[:, None, :]  # (K, C, E)
    y = yg.new_zeros((T + 1, E)).index_put((slots.reshape(-1),), yg.reshape(K * capacity, E))
    return y[:T].reshape(B, N, E)


class MoEFeedForward(nn.Module):
    """Top-1 routed MoE FFN: ``x (B, N, E) -> (y (B, N, E), aux)``, ``y``
    each token's expert output scaled by its router probability, ``aux =
    K * sum_k frac_k * mean_prob_k`` (``frac`` the share of tokens routed
    to expert k, in the input's type and without gradient, ``mean_prob``
    the mean router probability)."""

    def __init__(self, embed_dim: int, ffn_dim: int, n_experts: int = 4,
                 dispatch: str = "masked", capacity_factor: float = 1.25):
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown dispatch {dispatch!r}")
        E, F, K = embed_dim, ffn_dim, n_experts
        self.router = nn.Linear(E, K, bias=False)
        self.wi = nn.Parameter(torch.empty(K, E, F))
        self.bi = nn.Parameter(torch.zeros(K, F))
        self.wo = nn.Parameter(torch.empty(K, F, E))
        self.bo = nn.Parameter(torch.zeros(K, E))
        self.n_experts = K
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: ``lecun_normal`` on ``wi`` and ``wo``, whose
        fan-in counts the leading expert axis as receptive field (``E*K``
        for ``wi``, ``F*K`` for ``wo``), zero biases. (The router is an
        ``nn.Linear``, initialised with the model's other Dense layers.)"""
        from ..models.layers import lecun_normal_  # models imports this module

        K, E, F = self.wi.shape
        lecun_normal_(self.wi, E * K, generator)
        lecun_normal_(self.wo, F * K, generator)
        with torch.no_grad():
            self.bi.zero_()
            self.bo.zero_()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        onehot_dtype = x.dtype
        x = x.to(torch.promote_types(x.dtype, self.wi.dtype))
        probs = torch.softmax(self.router(x), dim=-1)  # (B, N, K)
        assign = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
        onehot = torch.nn.functional.one_hot(assign, self.n_experts).to(onehot_dtype)
        gate = (probs * onehot).sum(-1)  # (B, N) the chosen expert's probability
        frac = global_mean(onehot.to(probs.dtype).mean(dim=(0, 1))).to(onehot_dtype)
        aux = self.n_experts * (frac * global_mean(probs.mean(dim=(0, 1)))).sum()
        if self.dispatch == "capacity":
            # under a batch_shard context the slots are the global batch's, as the JAX
            # package's one program over the sharded batch lays them out
            shard = current()
            world = 1 if shard is None else shard.world
            cap = expert_capacity(world * x.shape[0] * x.shape[1], self.n_experts,
                                  self.capacity_factor)
            before = None if shard is None else tokens_before(assign, self.n_experts, shard)
            y = expert_compute_capacity(x, assign, self.wi, self.bi, self.wo, self.bo, cap,
                                        before=before)
        else:
            y = expert_compute(x, onehot, self.wi, self.bi, self.wo, self.bo)
        return y * gate[..., None], aux


EXPERT_LEAVES = ("wi", "bi", "wo", "bo")


def place_ep_params(params: Dict, mesh, axis_name: str = "expert",
                    device: str | torch.device = "cpu") -> Dict[str, torch.Tensor]:
    """A :class:`MoEFeedForward`'s flax tree (``router/kernel`` and the
    stacked ``wi``/``bi``/``wo``/``bo``) as this rank's tensors on
    ``device``: the router whole, the experts cut to the rank's
    consecutive ``K/n`` (every rank holds the same tree)."""
    rank, n = mesh.get_local_rank(axis_name), mesh[axis_name].size()
    out = {"router": torch.as_tensor(np.asarray(params["router"]["kernel"])).to(device)}
    for leaf in EXPERT_LEAVES:
        full = torch.as_tensor(np.asarray(params[leaf]))
        if full.shape[0] % n:
            raise ValueError(f"{full.shape[0]} experts do not split over {n} ranks")
        k = full.shape[0] // n
        out[leaf] = full[rank * k:(rank + 1) * k].clone().to(device)
    return out


def make_ep_apply(module: MoEFeedForward, mesh, axis_name: str = "expert"):
    """``apply(params, x) -> (y, aux)`` with the experts sharded over
    ``axis_name``: ``params`` from :func:`place_ep_params` (tensors, which
    may require grad), ``x (B, N, E)`` the same on every rank. Honours
    ``module.dispatch`` and ``module.capacity_factor``; ``y`` and ``aux``
    are the one-device module's, on every rank."""
    from .comm import copy_to_group, reduce_from_group

    group, rank = mesh.get_group(axis_name), mesh.get_local_rank(axis_name)
    K = module.n_experts

    def apply(params: Dict[str, torch.Tensor], x: torch.Tensor):
        n_local = params["wi"].shape[0]
        first = rank * n_local
        probs = torch.softmax(x @ params["router"], dim=-1)  # (B, N, K), replicated
        assign = torch.argmax(probs, dim=-1)
        onehot = torch.nn.functional.one_hot(assign, K).to(x.dtype)
        gate = (probs * onehot).sum(-1)
        aux = K * (onehot.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
        xe = copy_to_group(x, group)
        w = [params[leaf] for leaf in EXPERT_LEAVES]
        if module.dispatch == "capacity":
            cap = expert_capacity(x.shape[0] * x.shape[1], K, module.capacity_factor)
            y = expert_compute_capacity(xe, assign, *w, cap, first_expert=first, n_experts=K)
        else:
            y = expert_compute(xe, onehot[..., first:first + n_local], *w)
        return reduce_from_group(y, group) * gate[..., None], aux

    return apply
