"""Weight interchange with the JAX package's flax variable trees."""

from .jax_weights import (
    cls_kwargs,
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)

__all__ = ["cls_kwargs", "load_flax_variables", "model_kwargs", "random_flax_variables",
           "to_flax_variables"]
