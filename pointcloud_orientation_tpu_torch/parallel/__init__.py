"""The parallelism layer of the port on ``torch.distributed``: meshes and
batch shards (:mod:`.mesh`), multi-process start-up (:mod:`.multihost`),
FSDP (:mod:`.fsdp`), tensor (:mod:`.tp`), pipeline (:mod:`.pp`) and
expert (:mod:`.ep`) parallelism, ring attention (:mod:`.ring_attention`)
and the sequence-parallel transformer (:mod:`.sp_transformer`), with the
JAX package's ``__all__``. Data parallelism itself lives in the
``Trainer`` and the predictor (``mesh=``)."""

from .. import models as _models  # noqa: F401  (models imports .ep and .sp_transformer first)
from .ep import (MoEFeedForward, expert_capacity, expert_compute, expert_compute_capacity,
                 make_ep_apply, place_ep_params)
from .fsdp import fsdp_param_specs, make_fsdp_train_step, shard_fsdp_params
from .mesh import batch_sharding, data_axis_size, make_mesh, replicate, shard_batch
from .multihost import (
    global_batch_from_local,
    initialize as initialize_multihost,
    make_hybrid_mesh,
    process_local_slice,
)
from .pp import make_pp_apply, make_pp_train_step, place_pipeline_state, split_pipeline_params
from .ring_attention import make_ring_attention, ring_attention
from .sp_transformer import RingPointTransformer, make_sp_train_step
from .tp import make_tp_train_step, shard_tp_params, tp_param_specs

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicate",
    "shard_batch",
    "data_axis_size",
    "tp_param_specs",
    "shard_tp_params",
    "make_tp_train_step",
    "split_pipeline_params",
    "place_pipeline_state",
    "make_pp_apply",
    "make_pp_train_step",
    "MoEFeedForward",
    "place_ep_params",
    "expert_capacity",
    "make_ep_apply",
    "fsdp_param_specs",
    "shard_fsdp_params",
    "make_fsdp_train_step",
    "ring_attention",
    "make_ring_attention",
    "RingPointTransformer",
    "make_sp_train_step",
    "initialize_multihost",
    "make_hybrid_mesh",
    "process_local_slice",
    "global_batch_from_local",
    "expert_compute",
    "expert_compute_capacity",
]
