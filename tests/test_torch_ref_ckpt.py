"""The reference's PyTorch checkpoint layout in the port against the JAX
package's ``utils/torch_import.py`` and ``utils/torch_export.py``: the
export of the same weights key for key and array for array, a reference
``state_dict`` imported by both stacks into equal trees and equal outputs,
the predictor served from a ``.pth``, and ``evaluate`` on a plygt tree."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pointcloud_orientation_tpu.utils import torch_export as jax_export
from pointcloud_orientation_tpu.utils import torch_import as jax_import
from pointcloud_orientation_tpu_torch.data import OrientationDataset, offline, write_ply
from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
from pointcloud_orientation_tpu_torch.models import MODEL_REGISTRY
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import evaluate as E
from pointcloud_orientation_tpu_torch.utils import (
    export_state_dict,
    import_state_dict,
    load_flax_variables,
    load_reference_state_dict,
    load_torch_checkpoint,
    model_kwargs,
    random_flax_variables,
    save_torch_checkpoint,
    to_flax_variables,
)
from pointcloud_orientation_tpu_torch.utils.torch_import import HEADS

SEED = 7
N = 256
SMALL_PT = {"depth": 2, "ffn_dim": 64}
# model -> random_flax_variables options (the JAX model's options follow from the tree)
_MODELS = {
    "pointnet_pp_8dir": {},
    "pointnet_pp_fwd": {},
    "pointnet_pp_von_mises": {"mu_parameterization": "atan2"},
    "pointnet_pp_mvm": {"mu_init": "spread"},
    "pointnet_pp": {},
    "pointnet_pp_xyz": {},
    "pointnet_pp_xyz_schmidt": {},
    "point_transformer": SMALL_PT,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops, restored after
    (tests/test_torch_per_label.py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_export(model, v):
    if model == "point_transformer":
        return jax_export.export_point_transformer_state_dict(v["params"])
    return jax_export.export_pointnet_pp_state_dict(v["params"], v["batch_stats"], model)


def _port_module(model, v):
    return load_flax_variables(MODEL_REGISTRY[model](**model_kwargs(model, v["params"])), v)


def _assert_same_tree(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same_tree(got[k], w, f"{where}/{k}")
        else:
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, f"{where}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{where}/{k}")


@pytest.mark.parametrize("model", list(_MODELS))
def test_export_equals_jax_key_for_key(model):
    """The port's module, loaded with a flax tree, exported to the
    reference's names: the same keys, dtypes and arrays as the JAX
    exporter's output for that tree; imported back (both stacks' importers)
    it gives the tree again."""
    v = random_flax_variables(SEED, model, **_MODELS[model])
    want = _jax_export(model, v)
    got = export_state_dict(**to_flax_variables(_port_module(model, v)), model=model)
    _assert_same_tree(got, want)
    params, stats = import_state_dict(got, model)
    jparams, jstats = (jax_import.import_point_transformer_state_dict(want)
                       if model == "point_transformer"
                       else jax_import.import_pointnet_pp_state_dict(want, model))
    _assert_same_tree(params, jparams)
    _assert_same_tree(stats, jstats)
    _assert_same_tree(params, v["params"])
    if model != "point_transformer":
        _assert_same_tree(stats, v["batch_stats"])


def _jax_outputs(model, params, stats, clouds):
    if model == "point_transformer":
        jm, variables = JAX_MODELS[model](**SMALL_PT), {"params": params}
    else:
        jm = JAX_MODELS[model](sampling="first", **model_kwargs(model, params))
        variables = {"params": params, "batch_stats": stats}
    out = jm.apply(variables, jnp.asarray(clouds))
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("model", list(_MODELS))
def test_reference_checkpoint_serves_as_in_jax(tmp_path, rng, model):
    """A reference ``.pth`` written by the JAX package's exporter, read by
    both stacks' ``load_torch_checkpoint``: equal trees; the port's
    ``OrientationPredictor.from_torch_checkpoint`` (``sampling="first"``)
    against the JAX model on them, within 1e-5 relative (1e-5 absolute
    below 1)."""
    v = random_flax_variables(SEED, model, **_MODELS[model])
    path = str(tmp_path / "ref.pth")
    torch.save(jax_export.to_torch_state_dict(_jax_export(model, v)), path)
    params, stats = load_torch_checkpoint(path, model)
    jparams, jstats = jax_import.load_torch_checkpoint(path, model)
    _assert_same_tree(params, jparams)
    _assert_same_tree(stats, jstats)
    clouds = rng.normal(size=(2, N, 3)).astype(np.float32)
    kw = {} if model == "point_transformer" else {"sampling": "first"}
    pred = OrientationPredictor.from_torch_checkpoint(path, model, num_points=N, device="cpu",
                                                      **kw)
    got = pred(clouds)
    got = got if isinstance(got, tuple) else (got,)
    want = _jax_outputs(model, jparams, jstats, clouds)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_unported_layouts_raise():
    with pytest.raises(NotImplementedError):
        import_state_dict({}, "moe_point_transformer")
    with pytest.raises(NotImplementedError):
        export_state_dict({}, None, "moe_point_transformer")
    with pytest.raises(KeyError):
        import_state_dict({"nonsense.weight": np.zeros(3)}, "pointnet_pp_8dir")
    assert set(HEADS) == set(jax_import._HEADS)


def test_predictor_from_a_pth_reproduces_the_trained_weights_bit_for_bit(tmp_path, rng):
    """``save_torch_checkpoint`` of a port module, served back by
    ``from_torch_checkpoint``: the same request output, bit for bit, as the
    predictor built from the module's flax tree; the predictor's refusals
    stay."""
    for model in ("pointnet_pp_8dir", "point_transformer"):
        v = random_flax_variables(SEED + 1, model, **_MODELS[model])
        module = _port_module(model, v)
        path = str(tmp_path / f"{model}.pth")
        save_torch_checkpoint(path, **to_flax_variables(module), model=model)
        sd = torch.load(path, weights_only=True)
        assert all(isinstance(t, torch.Tensor) for t in sd.values())
        clouds = rng.normal(size=(3, 200, 3)).astype(np.float32)
        tree = to_flax_variables(module)
        want = OrientationPredictor(model, tree["params"], tree["batch_stats"], num_points=N,
                                    device="cpu")(clouds)
        got = OrientationPredictor.from_torch_checkpoint(path, model, num_points=N,
                                                         device="cpu")(clouds)
        np.testing.assert_array_equal(got, want)
        other = MODEL_REGISTRY[model](**model_kwargs(model, v["params"]))
        load_reference_state_dict(other, sd, model)
        for a, b in zip(other.state_dict().values(), module.state_dict().values()):
            if a.is_floating_point():
                assert torch.equal(a, b)
    # a mesh is not ported; one checkpoint's weights have no member axis to ensemble
    for kw, error in (({"mesh": object()}, NotImplementedError),
                      ({"ensemble_size": 2}, ValueError)):
        with pytest.raises(error):
            OrientationPredictor.from_torch_checkpoint(path, "point_transformer", device="cpu",
                                                       **kw)


@pytest.fixture(scope="module")
def plygt_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(1)
    for cls in ("chair", "bottle", "sofa"):
        os.makedirs(base / "c" / cls)
        for i in range(8):
            write_ply(rng.normal(size=(200, 3)).astype(np.float32), base / "c" / cls / f"{i}.ply")
    offline.rotate_tree(str(base / "c"), str(base / "r"), seed=2)
    offline.generate_8dir_gt(str(base / "r"))
    offline.generate_single_peak_gt(str(base / "r"))
    offline.generate_mvm_gt(str(base / "r"), str(base / "r"))
    return str(base / "r")


def test_evaluate_returns_the_jax_keys_and_agrees_with_test(plygt_tree, tmp_path):
    """``evaluate`` on a plygt tree with a ``.pth`` of a trainer's weights
    (and with the port's own checkpoint, and through its CLI) returns the
    JAX function's keys (``loss``, ``mean_angular_error_deg``,
    ``per_class``, ``count``) and equals ``Trainer.test`` on those weights."""
    cfg = preset("8dir_kl", num_points=128, batch_size=8, epochs=1, rotation_mode="none")
    ds = OrientationDataset.from_ply_tree(plygt_tree, 128, load_sidecars=True)
    trainer = Trainer(cfg, ds, device="cpu")
    trainer.fit(log_every=0)
    trainer.load_best()
    pth = str(tmp_path / "best.pth")
    save_torch_checkpoint(pth, **to_flax_variables(trainer.model), model=cfg.model)
    ckpt = trainer.save_checkpoint(str(tmp_path / "ckpt"))
    test = trainer.test()
    want = {"loss": test.mean_loss, "mean_angular_error_deg": test.mean_angular_error,
            "per_class": test.per_class_mean(), "count": test.count}
    got = E.evaluate(cfg, ds, torch_ckpt=pth, device="cpu")
    assert set(got) == {"loss", "mean_angular_error_deg", "per_class", "count"}
    assert got == want and np.isfinite(got["loss"]) and got["count"] > 0
    assert E.evaluate(cfg, ds, ckpt=ckpt, device="cpu")["count"] == got["count"]
    cli = E.main(["--preset", "8dir_kl", "--data", f"plygt:{plygt_tree}", "--num-points", "128",
                  "--batch-size", "8", "--device", "cpu", "--torch-ckpt", pth])
    assert set(cli["per_class"]) == {"chair", "bottle", "sofa"} and np.isfinite(cli["loss"])
