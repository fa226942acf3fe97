"""Weight interchange with the JAX package's flax variable trees and with
the reference's PyTorch checkpoints."""

from .jax_weights import (
    cls_kwargs,
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)
from .torch_export import export_state_dict, save_torch_checkpoint
from .torch_import import import_state_dict, load_reference_state_dict, load_torch_checkpoint

__all__ = ["cls_kwargs", "export_state_dict", "import_state_dict", "load_flax_variables",
           "load_reference_state_dict", "load_torch_checkpoint", "model_kwargs",
           "random_flax_variables", "save_torch_checkpoint",
           "to_flax_variables"]
