"""The lockstep protocols over a mesh (``run_multi_seed``,
``run_per_label_vmapped`` with ``mesh=``) as gloo ranks at world size 2 and
4: the members go over the mesh's first axis, a rank training its
``L/n``; each member's result is the meshless run's bit for bit (each is a
``Trainer`` of its own, as in the JAX contract that a member does not
depend on its slot), the protocol checkpoint holds every member in key
order in the layout the meshless run writes, and a member count that does
not divide raises the JAX ``ValueError``."""

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.train import multiseed as jax_multiseed
from pointcloud_orientation_tpu_torch.train.ensemble import run_per_label_vmapped
from pointcloud_orientation_tpu_torch.train.multiseed import run_multi_seed
import torch_parallel_ranks as R

WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(scope="module")
def ranks():
    return R.run_ranks("protocols", WORLDS)


@pytest.fixture(scope="module")
def meshless():
    ds = R.small_dataset(samples_per_class=8, num_points=128)
    cfg = R.protocol_config()
    return {"multi_seed": run_multi_seed(cfg, ds, list(range(1, max(WORLDS) + 1)), device="cpu",
                                         log_every=0, return_params=True),
            "per_label": run_per_label_vmapped(cfg, ds, labels=list(ds.class_names[:4]),
                                               device="cpu", log_every=0)}


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k])
        else:  # NaN equal to NaN (the 8-dir task's angular error)
            np.testing.assert_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_multi_seed_over_the_mesh_is_the_meshless_run(ranks, meshless, n):
    got = ranks[n]["multi_seed"]
    assert list(got) == list(range(1, n + 1))
    for s in got:
        _same(got[s], meshless["multi_seed"][s])


@pytest.mark.parametrize("n", WORLDS)
def test_per_label_over_the_mesh_is_the_meshless_run(ranks, meshless, n):
    got = ranks[n]["per_label"]
    assert len(got) == n
    for label in got:
        _same(got[label], meshless["per_label"][label])


@pytest.mark.parametrize("n", WORLDS)
def test_checkpoint_and_files_gathered_on_the_first_rank(ranks, n):
    assert ranks[n]["carry_seeds"] == list(range(1, n + 1))
    assert ranks[n]["carry_members"] == n
    assert ranks[n]["files"] == [f"seed_{s}" for s in range(1, n + 1)] + ["seeds_summary.json"]


@pytest.mark.parametrize("n", WORLDS)
def test_member_count_must_divide(ranks, n):
    """The message of the JAX protocols' check (``train/multiseed.py``)."""
    import inspect

    assert "must divide over mesh axis" in inspect.getsource(jax_multiseed.run_multi_seed)
    assert ranks[n]["indivisible"] == (f"seed count {n - 1} must divide over mesh axis 'data' "
                                       f"of size {n}")
