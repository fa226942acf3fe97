"""Device meshes over ``torch.distributed`` and the batch's shards on them.

Counterpart of ``pointcloud_orientation_tpu/parallel/mesh.py``. The JAX
package builds a ``jax.sharding.Mesh`` over the devices one process sees
and lets XLA partition a jitted step over it. The port runs one process a
device (a rank), so a mesh is a ``torch.distributed`` ``DeviceMesh`` over
ranks, each of its named axes a process group; the collectives are
written out (``parallel/*.py``, the trainer, the predictor). The backend
is named, never guessed: ``nccl`` for ``device="cuda"``, ``gloo`` for
``device="cpu"``, unless the caller names another; ``nccl`` with no GPU
raises, nothing moves to the CPU by itself.

Without a launcher (one process, no ``torchrun`` environment)
:func:`make_mesh` starts a process group of world size 1 on a free
``localhost`` port, so the same code runs from one process to many.

A batch sharded over an axis is each rank's contiguous slice of the
leading dimension in rank order, as ``P("data")`` lays it out: rank ``r``
of ``n`` holds rows ``[r * B/n, (r + 1) * B/n)``.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.batch_shard import BatchShard

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def default_backend(device: str) -> str:
    """``nccl`` for ``"cuda"``, ``gloo`` for ``"cpu"``."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"device {device!r}: the port's meshes run on 'cuda' or 'cpu'")
    return BACKENDS[kind]


def check_backend(backend: str) -> None:
    """Raise when ``backend`` cannot run here: ``nccl`` needs a GPU."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device and torch.cuda.is_available() "
                           "is False; a mesh on the CPU takes device='cpu' (backend 'gloo')")


def free_port() -> int:
    """A free TCP port on ``localhost``."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(backend: str, device: str = "cuda") -> None:
    """Join the launcher's process group (:func:`.multihost.initialize`),
    or start one of world size 1 when nothing hints at a launch. Raises
    ``ValueError`` when a group already runs on another backend."""
    from .multihost import initialize

    check_backend(backend)
    initialize(backend=backend, device=device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    running = dist.get_backend()
    if running != backend:
        raise ValueError(f"the process group runs on {running!r}, the mesh asks for {backend!r}")


def mesh_sizes(axis_names: Sequence[str], axis_sizes: Optional[Sequence[int]], n: int) -> list:
    """The JAX package's shape rule: one axis takes all ``n`` devices; with
    several, ``axis_sizes`` fixes the shape (the first axis takes all when
    it is None) and one entry may be -1 to absorb the rest. ``ValueError``
    when the shape does not cover ``n``."""
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    sizes = [int(s) for s in axis_sizes]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} does not cover {n} devices")
    return sizes


def make_mesh(axis_names: Sequence[str] = ("data",), axis_sizes: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[int]] = None, backend: Optional[str] = None,
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``device`` type with named axes over the ranks
    ``devices`` (every rank of the world by default; every rank calls
    this, as it creates the axes' groups). ``backend``: ``nccl`` for cuda,
    ``gloo`` for cpu unless named (``gloo`` takes CUDA tensors too, which
    lets two processes share one card)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    kind = torch.device(device).type
    backend = backend or default_backend(kind)
    ensure_process_group(backend, kind)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    sizes = mesh_sizes(axis_names, axis_sizes, len(ranks))
    if devices is None:
        return init_device_mesh(kind, tuple(sizes), mesh_dim_names=tuple(axis_names))
    return DeviceMesh(kind, torch.tensor(ranks).reshape(sizes), mesh_dim_names=tuple(axis_names))


def data_axis_size(mesh, axis: str = "data") -> int:
    """The size of ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh[axis].size()


def batch_sharding(mesh, axis: str = "data") -> BatchShard:
    """The sharding that splits the leading (batch) dimension over ``axis``:
    this rank's place in it and the group its collectives run on, read from
    the mesh once."""
    return BatchShard(mesh.get_group(axis), mesh.get_local_rank(axis), mesh[axis].size(), axis)


def map_tree(fn, tree, *others, path=()):
    """``fn(path, leaf, *other_leaves)`` over a tree of dicts, lists and
    tuples (``others`` like-structured, read where ``tree`` branches)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(o[i] for o in others), path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *others)


def shard_batch(tree, mesh, axis: str = "data"):
    """Each tensor or array of a batch tree cut to this rank's rows of its
    leading axis (the rank's part of ``P(axis)``)."""
    sharding = batch_sharding(mesh, axis)
    return map_tree(lambda path, x: x[sharding.rows(x.shape[0])], tree)


def replicate(tree, mesh):
    """Every tensor of ``tree`` (a module's parameters and buffers, or a
    dict/list of tensors) made equal on every rank of ``mesh``: broadcast
    along each axis in turn from its first rank, so all hold the first
    rank's values. In place; returns ``tree``."""
    tensors = ([*tree.parameters(), *tree.buffers()] if isinstance(tree, torch.nn.Module)
               else [])
    if not isinstance(tree, torch.nn.Module):
        map_tree(lambda path, x: tensors.append(x) if torch.is_tensor(x) else None, tree)
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=src, group=group)
    return tree
