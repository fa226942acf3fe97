"""The rule that holds a train step's gradients through the kernels against
the plain versions (``utils/grad_check.py``, used by ``chip_smoke.py`` and
the card tests): which leaves it leaves out, and the group-all shift leaf
held by an absolute bound where its premise (every pooled value > 0) holds
and by the relative bound where it fails."""

import pytest
import torch

from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY
from pointcloud_orientation_tpu_torch.utils import grad_check as GC

SHIFT, SCALE = "sa3.mlp.bns.2.bias", "sa3.mlp.bns.2.weight"


def _pair(noise_scale=1e-7):
    """Gradients of a classifier-like tree: ``want`` from a seed, ``got``
    within 1e-6 relative of it on every leaf; the shift leaf near zero on
    both sides (its exact value is 0 when the premise holds)."""
    g = torch.Generator().manual_seed(0)
    want = {SCALE: torch.randn(1024, generator=g), "fc1.weight": torch.randn(512, 1024, generator=g),
            "fc1.bias": 1e-7 * torch.randn(512, generator=g),
            SHIFT: noise_scale * torch.randn(1024, generator=g)}
    got = {k: v * (1 + 1e-7) for k, v in want.items()}
    got[SHIFT] = noise_scale * torch.randn(1024, generator=g)  # noise against noise
    return got, want


def test_premise_holds_the_shift_leaf_by_an_absolute_bound():
    """Premise holds: the shift's noise (relative error near 1.4) is held
    against ``tol`` times the scale leaf's norm and passes; a wrong shift
    gradient of 1e-2 of that norm fails at ``tol`` 1e-3."""
    got, want = _pair()
    skip, shifts = {"fc1.bias"}, {SHIFT: SCALE}
    res = GC.compare_grads(got, want, 1e-3, skip, shifts, premise=True)
    assert res["ok"] and res["group_all_shift"][SHIFT]["rule"] == "absolute"
    assert res["group_all_shift"][SHIFT]["err"] < 1e-5
    assert "fc1.bias" not in res["group_all_shift"] and res["worst"] != "fc1.bias"
    bad = dict(got)
    bad[SHIFT] = want[SHIFT] + 1e-2 * want[SCALE].norm() / 32.0 * torch.ones(1024)
    res = GC.compare_grads(bad, want, 1e-3, skip, shifts, premise=True)
    assert not res["ok"] and res["worst"] == SHIFT


def test_premise_fails_the_shift_leaf_is_held_relatively():
    """A zero pooled maximum breaks the premise: the shift carries a real
    gradient and is held by the relative bound, so a gradient 1% off fails
    at 1e-3 (and one within 1e-6 passes), where the absolute bound would
    have let it through."""
    pooled = [torch.rand(4, 1, 1024) + 0.1]
    assert GC.pooled_all_positive(pooled)
    pooled[0][2, 0, 17] = 0.0
    assert not GC.pooled_all_positive(pooled) and not GC.pooled_all_positive([])
    _, want = _pair(noise_scale=0.05)  # a real gradient, 1/20 of the scale leaf's
    skip, shifts = {"fc1.bias"}, {SHIFT: SCALE}
    got = {k: v * (1 + 1e-6) for k, v in want.items()}
    res = GC.compare_grads(got, want, 1e-3, skip, shifts, premise=False)
    assert res["ok"] and res["group_all_shift"][SHIFT]["rule"] == "relative"
    got[SHIFT] = want[SHIFT] * 1.01
    res = GC.compare_grads(got, want, 1e-3, skip, shifts, premise=False)
    assert not res["ok"] and res["worst"] == SHIFT and res["norm_rel_err"] == pytest.approx(
        1e-2, rel=1e-3)
    assert GC.compare_grads(got, want, 1e-3, skip, shifts, premise=True)["ok"]
    got["fc1.weight"] = torch.full_like(got["fc1.weight"], float("nan"))
    assert not GC.compare_grads(got, want, 1.0, skip, shifts, premise=False)["ok"]


@pytest.mark.parametrize("name, shift", [
    ("pointnet_pp_cls", "sa3.mlp.bns.2.bias"),
    ("pointnet_pp_xyz_schmidt", "trunk.sa3.mlp.bns.2.bias"),
    ("pointnet_pp_8dir", "trunk.sa3.mlp.bns.2.bias"),
    ("pointnet_pp_mvm", None),
])
def test_leaves_and_the_hook_on_the_models(name, shift):
    """The leaves left out are the Dense biases that a train BatchNorm
    normalises (every shared-MLP layer's, and fc1/fc2 of a BatchNorm
    funnel; the MvM head's LayerNorm funnel keeps its fc biases); the shift
    leaf is the group-all stage's last BatchNorm bias where fc1's BatchNorm
    follows it (none on the LayerNorm funnel); the forward hook reads each
    train forward's pooled values, ``(B, 1, 1024)``, and is removed after."""
    kw = {"num_classes": 5} if name == "pointnet_pp_cls" else {"sampling": "first"}
    model = MODEL_REGISTRY[name](**kw).train()
    skip = GC.bias_leaves_feeding_batch_norm(model)
    prefix = "" if name == "pointnet_pp_cls" else "trunk."
    linears = {f"{prefix}sa{i}.mlp.linears.{j}.bias" for i in (1, 2, 3) for j in range(3)}
    fcs = {f"{prefix}fc1.bias", f"{prefix}fc2.bias"}
    assert skip == (linears if name == "pointnet_pp_mvm" else linears | fcs)
    shifts = GC.group_all_shift_leaves(model)
    params = dict(model.named_parameters())
    assert shifts == ({shift: shift.replace("bias", "weight")} if shift else {})
    assert all(n in params for pair in shifts.items() for n in pair)
    x = torch.randn(2, 512, 3)
    with GC.record_group_all(model) as pooled:
        model(x, torch.Generator().manual_seed(0))
        model(x, torch.Generator().manual_seed(1))
    assert len(pooled) == (0 if shift is None else 2)
    assert all(p.shape == (2, 1, 1024) and not p.requires_grad for p in pooled)
    model(x, torch.Generator().manual_seed(2))
    assert len(pooled) == (0 if shift is None else 2)  # the hook is gone
