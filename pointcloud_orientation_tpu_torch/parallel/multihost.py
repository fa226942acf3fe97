"""Multi-process start-up, hybrid meshes and per-process batches.

Counterpart of ``pointcloud_orientation_tpu/parallel/multihost.py``. The
JAX package runs a process a host and reads its coordinator from
``JAX_COORDINATOR_ADDRESS``; the port runs a process a device and reads
``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``):

1. :func:`initialize` joins the process group (idempotent, a no-op when
   nothing hints at a multi-process launch, so entry points call it
   unconditionally);
2. :func:`make_hybrid_mesh` keeps the slow cross-host (DCN) part of each
   axis outermost, so collectives that need bandwidth stay inside a host;
3. :func:`process_local_slice` and :func:`global_batch_from_local` give
   each process its disjoint rows of the global batch and assemble them
   into a batch-sharded ``DTensor``.

Ranks are numbered host by host (``torchrun``'s ``RANK = node *
nproc_per_node + LOCAL_RANK``), so a host's ranks are a contiguous block.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import check_backend, default_backend

_INITIALIZED = False
# torchrun's environment: any of these says the process is one of several
LAUNCH_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: str = "cuda", **kwargs) -> None:
    """Join the multi-process group (idempotent). A no-op when a group is
    already up (here or by a launcher) or when nothing hints at a
    multi-process launch: no ``coordinator_address`` (``host:port``), no
    explicit ``num_processes``/``process_id`` (as strong a hint as an
    address: silently doing nothing would train N copies of one job) and
    none of torchrun's variables. The world size and rank come from the
    arguments, else ``WORLD_SIZE``/``RANK``; the address from the
    argument, else ``MASTER_ADDR``/``MASTER_PORT``. On ``device="cuda"``
    the process takes the card ``LOCAL_RANK`` (default: its rank) modulo
    the card count. ``backend``: ``nccl`` for cuda, ``gloo`` for cpu,
    unless named."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return
    env = os.environ
    hinted = (coordinator_address is not None or num_processes is not None
              or process_id is not None or any(env.get(k) for k in LAUNCH_ENV))
    if not hinted:
        return
    kind = torch.device(device).type
    backend = backend or default_backend(kind)
    check_backend(backend)
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    init = (f"tcp://{coordinator_address}" if coordinator_address is not None else "env://")
    if kind == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kwargs)
    _INITIALIZED = True


def make_hybrid_mesh(axis_names: Sequence[str], ici_shape: Sequence[int],
                     dcn_shape: Sequence[int], devices: Optional[Sequence[int]] = None,
                     backend: Optional[str] = None, device: str = "cuda"):
    """A mesh whose axis ``i`` has ``ici_shape[i] * dcn_shape[i]`` ranks,
    the DCN factor outermost: consecutive ranks of an axis share a host
    (a "slice" is a host's contiguous block of ranks). One ICI entry may be
    -1 to absorb the rest of a host. With every DCN entry 1 it is
    :func:`.mesh.make_mesh` of ``ici_shape``. ``ValueError`` when the
    three lengths differ or the shape does not cover the ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    from .mesh import ensure_process_group

    if len(axis_names) != len(ici_shape) or len(axis_names) != len(dcn_shape):
        raise ValueError(f"axis_names/ici_shape/dcn_shape lengths differ: "
                         f"{len(axis_names)}/{len(ici_shape)}/{len(dcn_shape)}")
    kind = torch.device(device).type
    ensure_process_group(backend or default_backend(kind), kind)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(ranks)
    dcn = [int(d) for d in dcn_shape]
    ici = [int(s) for s in ici_shape]
    n_slices = int(np.prod(dcn))
    if -1 in ici:
        known = int(np.prod([s for s in ici if s != -1]))
        ici[ici.index(-1)] = n // n_slices // known
    total = int(np.prod(ici)) * n_slices
    if total != n:
        raise ValueError(f"hybrid mesh ici={ici} x dcn={dcn} covers {total} devices, have {n}")
    k = len(ici)
    # (dcn..., ici...) host-major, then each axis's DCN factor outside its ICI factor
    grid = np.asarray(ranks).reshape(dcn + ici)
    grid = grid.transpose([a for i in range(k) for a in (i, k + i)])
    grid = grid.reshape([d * s for d, s in zip(dcn, ici)])
    return DeviceMesh(kind, torch.from_numpy(np.ascontiguousarray(grid)),
                      mesh_dim_names=tuple(axis_names))


def process_local_slice(global_batch: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> Tuple[int, int]:
    """This process's ``(start, size)`` of a global batch (its rank and the
    world size by default; 0 of 1 without a group). ``ValueError`` when the
    batch does not divide evenly: every rank runs the same shapes."""
    up = dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} processes")
    size = global_batch // pc
    return pi * size, size


def global_batch_from_local(mesh, local_batch, axis: str = "data"):
    """The global batch-sharded ``DTensor`` whose ``axis`` shards are the
    ranks' ``local_batch`` rows (``Shard(0)`` over ``axis``, replicated
    over the mesh's other axes); its shape is ``(sum of the local rows,
    *rest)``. One process: the whole batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = torch.as_tensor(np.asarray(local_batch) if not torch.is_tensor(local_batch)
                            else local_batch)
    placements = [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(local.to(mesh.device_type), mesh, placements)
