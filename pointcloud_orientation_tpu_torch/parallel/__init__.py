"""The one-device part of the JAX package's ``parallel/``: the MoE
feed-forward and its two dispatches (:mod:`.ep`)."""

from .ep import MoEFeedForward, expert_capacity, expert_compute, expert_compute_capacity

__all__ = ["MoEFeedForward", "expert_capacity", "expert_compute", "expert_compute_capacity"]
