"""Weight interchange with the JAX package's flax variable trees and with
the reference's PyTorch checkpoints; the ``.pt2`` serving artifacts, int8
weights and profiling helpers."""

from .aot_export import export_orientation_model, load_artifact, save_artifact
from .jax_weights import (
    cls_kwargs,
    load_flax_variables,
    model_kwargs,
    random_flax_variables,
    to_flax_variables,
)
from .profiling import StepTimer, trace_annotation
from .quantize import (
    dequantize_params,
    load_quantized_checkpoint,
    param_bytes,
    quantize_params_int8,
    save_quantized_checkpoint,
)
from .torch_export import (
    export_point_transformer_state_dict,
    export_pointnet_pp_state_dict,
    export_pointnet_state_dict,
    export_state_dict,
    save_torch_checkpoint,
    to_torch_state_dict,
)
from .torch_import import (
    import_point_transformer_state_dict,
    import_pointnet_pp_state_dict,
    import_pointnet_state_dict,
    import_state_dict,
    load_reference_state_dict,
    load_torch_checkpoint,
)

__all__ = ["StepTimer", "cls_kwargs", "dequantize_params", "export_orientation_model",
           "export_point_transformer_state_dict", "export_pointnet_pp_state_dict",
           "export_pointnet_state_dict", "export_state_dict", "import_point_transformer_state_dict",
           "import_pointnet_pp_state_dict", "import_pointnet_state_dict", "import_state_dict",
           "load_artifact", "load_flax_variables", "load_quantized_checkpoint",
           "load_reference_state_dict", "load_torch_checkpoint", "model_kwargs", "param_bytes",
           "quantize_params_int8", "random_flax_variables", "save_artifact",
           "save_quantized_checkpoint", "save_torch_checkpoint", "to_flax_variables",
           "to_torch_state_dict", "trace_annotation"]
