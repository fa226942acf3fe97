"""The port's meshes and multi-process helpers (``parallel/mesh.py``,
``parallel/multihost.py``) as gloo ranks at world size 2 and 4, against
the JAX package's on its virtual mesh of as many devices: each rank's rows
of a sharded batch, the axes' layouts, the errors and their messages, the
per-process slices and the assembled global batch."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pointcloud_orientation_tpu import parallel as JP
from pointcloud_orientation_tpu_torch import parallel as TP
from torch_parallel_ranks import run_ranks

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("mesh", WORLDS)


def _jax_error(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("n", WORLDS)
def test_batch_shards_are_the_jax_layout(ranks, n):
    """Rank r's rows of a sharded batch are device r's shard of ``P("data")``;
    replicate gives every rank the first rank's values."""
    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    batch = np.arange(n * 2 * 5, dtype=np.float32).reshape(n * 2, 5)
    arr = JP.shard_batch(batch, mesh)
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    want = [by_device[d] for d in mesh.devices.flat]
    got = ranks[n]["shards"]
    assert len(got) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ranks[n]["axis_size"] == JP.data_axis_size(mesh) == n
    for t in ranks[n]["replicated"]:
        np.testing.assert_array_equal(t, np.zeros(3, np.float32))


@pytest.mark.parametrize("n", WORLDS)
def test_axes_layouts_match_jax(ranks, n):
    """A two-axis mesh with the -1 rule and a single-host hybrid mesh hold
    the ranks where the JAX meshes hold the devices; a DCN factor goes
    outside the ICI one (a host's ranks are consecutive)."""
    devs = jax.devices()[:n]
    two = JP.make_mesh(("data", "model"), (-1, 2), devs)
    ids = [[d.id for d in row] for row in two.devices]
    assert ranks[n]["two_axes"] == (ids, n // 2, 2)
    hybrid = JP.make_hybrid_mesh(("data", "model"), (-1, 2), (1, 1), devices=devs)
    assert ranks[n]["hybrid"] == [[d.id for d in row] for row in hybrid.devices]
    dcn = np.asarray(ranks[n]["hybrid_dcn"])
    assert dcn.shape == (n // 2, 2)
    per_host = n // 2
    # the model axis crosses hosts: its two ranks lie one host apart
    assert all(row[1] - row[0] == per_host for row in dcn.tolist())


@pytest.mark.parametrize("n", WORLDS)
def test_errors_are_the_jax_ones(ranks, n):
    """Not covering the devices, lengths that differ and a ragged batch
    raise the JAX ``ValueError`` with its message; a mesh on nccl without
    a GPU raises and names why."""
    devs = jax.devices()[:n]
    want = [_jax_error(lambda: JP.make_mesh(("data",), (n + 1,), devs)),
            _jax_error(lambda: JP.make_hybrid_mesh(("data",), (n + 1,), (1,), devices=devs)),
            _jax_error(lambda: JP.make_hybrid_mesh(("data", "model"), (n,), (1, 1),
                                                   devices=devs)),
            _jax_error(lambda: JP.process_local_slice(n * 2 + 1, process_index=0,
                                                      process_count=n))]
    got = ranks[n]["errors"]
    assert [e[0] for e in got[:4]] == ["ValueError"] * 4
    assert [e[1] for e in got[:4]] == want
    assert got[4][0] == "RuntimeError" and "nccl" in got[4][1] and "CUDA" in got[4][1]


@pytest.mark.parametrize("n", WORLDS)
def test_process_slices_and_global_batch(ranks, n):
    """Each rank's ``process_local_slice`` is the JAX one for its index, and
    the DTensor assembled from the ranks' rows is the whole batch, as the
    JAX global array is."""
    assert ranks[n]["local_slice"] == [JP.process_local_slice(n * 4, process_index=i,
                                                              process_count=n)
                                       for i in range(n)]
    shape, full = ranks[n]["global_batch"]
    batch = np.arange(n * 2 * 5, dtype=np.float32).reshape(n * 2, 5)
    mesh = JP.make_mesh(("data",), (n,), jax.devices()[:n])
    arr = JP.global_batch_from_local(mesh, batch)
    assert shape == arr.shape
    assert arr.sharding == NamedSharding(mesh, P("data"))
    np.testing.assert_array_equal(full, np.asarray(arr))
    np.testing.assert_allclose(np.asarray(jax.jit(lambda x: jnp.sum(x, 1))(arr)), full.sum(1))


@pytest.mark.parametrize("pc", [1, 2, 4, 8])
def test_process_local_slice_partitions_exactly(pc):
    for pi in range(pc):
        assert (TP.process_local_slice(64, process_index=pi, process_count=pc)
                == JP.process_local_slice(64, process_index=pi, process_count=pc))
    with pytest.raises(ValueError, match="not divisible"):
        TP.process_local_slice(10, process_index=0, process_count=4)


def test_initialize_is_a_noop_without_hints(monkeypatch):
    """No torchrun variable and no argument: no group is started (the
    JAX one's no-op); an explicit process count is a hint that would
    connect, so without an address it fails instead of training alone."""
    from pointcloud_orientation_tpu_torch.parallel import multihost

    for var in multihost.LAUNCH_ENV + ("MASTER_PORT",):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    TP.initialize_multihost(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises((ValueError, RuntimeError)):
        TP.initialize_multihost(num_processes=2, process_id=0, device="cpu")
    assert not dist.is_initialized()


def test_nccl_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="nccl"):
        TP.make_mesh(("data",))
    with pytest.raises(RuntimeError, match="nccl"):
        TP.make_mesh(("data",), backend="nccl", device="cpu")
    assert not dist.is_initialized()
