"""Real data in the port against the JAX package: the PLY reader and writers,
the four sidecar formats, the native parser built from ``native/fastply.cc``,
the HDF5 and PLY-tree loaders with stored targets, the offline tools, one
train step of 8dir_kl and of mvm on stored targets (``rotation_mode="none"``)
against the JAX float64 step, the prediction PLYs and the CLI's data specs.
Trees of 3 classes x 8 clouds x 200 points, as tests/test_sidecar_training.py
builds them."""

import filecmp
import json
import os
from types import SimpleNamespace
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu.data import OrientationDataset as JaxDataset
from pointcloud_orientation_tpu.data import hdf5 as jax_hdf5
from pointcloud_orientation_tpu.data import offline as jax_offline
from pointcloud_orientation_tpu.data import ply as jax_ply
from pointcloud_orientation_tpu.data import sidecar as jax_sidecar
from pointcloud_orientation_tpu.data.pipeline import make_augment_fn
from pointcloud_orientation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pointcloud_orientation_tpu.train import metrics as jax_metrics
from pointcloud_orientation_tpu.train import run as jax_run
from pointcloud_orientation_tpu.train import tasks as jax_tasks
from pointcloud_orientation_tpu.train.config import preset as jax_preset
from pointcloud_orientation_tpu.train.trainer import Trainer as JaxTrainer
from pointcloud_orientation_tpu_torch.data import (
    OrientationDataset,
    fastply,
    offline,
    ply,
    sidecar,
)
from pointcloud_orientation_tpu_torch.data.hdf5 import load_modelnet_hdf5
from pointcloud_orientation_tpu_torch.train import Trainer, preset
from pointcloud_orientation_tpu_torch.train import metrics as M
from pointcloud_orientation_tpu_torch.train import run as R
from pointcloud_orientation_tpu_torch.utils import (
    load_flax_variables,
    random_flax_variables,
    to_flax_variables,
)

CLASSES = ("chair", "bottle", "door")  # K 1 (clear), 0 (uniform, symmetric), 2
PER_CLASS, N = 8, 200
SEED = 42


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU ops, restored after
    (tests/test_torch_per_label.py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_canonical(root, seed=0):
    rng = np.random.default_rng(seed)
    for cls in CLASSES:
        os.makedirs(os.path.join(root, cls))
        for i in range(PER_CLASS):
            ply.write_ply(rng.normal(size=(N, 3)).astype(np.float32),
                          os.path.join(root, cls, f"{cls}_{i}.ply"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A canonical tree, and the port's rotated tree with all four sidecars
    (written by the port's offline tools)."""
    base = tmp_path_factory.mktemp("trees")
    canonical, rotated = str(base / "canonical"), str(base / "rotated")
    _write_canonical(canonical)
    offline.rotate_tree(canonical, rotated, mode="yaw", seed=1)
    offline.generate_8dir_gt(rotated)
    offline.generate_single_peak_gt(rotated)
    offline.generate_mvm_gt(rotated, rotated)
    return canonical, rotated


def _same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---------- PLY and sidecars ----------

def test_ply_writers_and_reader_match_jax_byte_for_byte(tmp_path, rng):
    pts = (rng.normal(size=(300, 3)) * 3).astype(np.float32)
    axes = [rng.normal(size=3) for _ in range(3)]
    for name, ours, theirs, args in (("w", ply.write_ply, jax_ply.write_ply, (pts,)),
                                     ("a", ply.write_ply_with_axes,
                                      jax_ply.write_ply_with_axes, (pts, axes))):
        ours(*args, tmp_path / f"{name}_port.ply")
        theirs(*args, tmp_path / f"{name}_jax.ply")
        assert _same_bytes(tmp_path / f"{name}_port.ply", tmp_path / f"{name}_jax.ply")
        got = ply.read_ply(tmp_path / f"{name}_port.ply")
        np.testing.assert_array_equal(got, jax_ply.read_ply(tmp_path / f"{name}_port.ply"))
        np.testing.assert_array_equal(ply.read_ply_numpy(tmp_path / f"{name}_port.ply"), got)
    assert got.shape == (304, 3) and not got[0].any()  # the edge rows stay out
    # six columns (normals) and a header without element vertex count, both readers
    six = tmp_path / "six.ply"
    body = "\n".join(" ".join(f"{v:.6f}" for v in row) for row in rng.normal(size=(5, 6)))
    six.write_text("ply\nformat ascii 1.0\nelement vertex 5\n" + "property float x\n" * 6
                   + "end_header\n" + body + "\n")
    np.testing.assert_array_equal(ply.read_ply(six), jax_ply.read_ply(six))
    assert ply.read_ply(six).shape == (5, 6)


def test_sidecars_round_trip_and_parse_as_jax(tmp_path, rng):
    axes = rng.normal(size=(3, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(8)).astype(np.float32)
    params = np.asarray([[1.25, 8.0, 0.5], [-2.5, 8.0, 0.5], [0, 0, 0], [0, 0, 0]], np.float32)
    cases = (("axes.txt", sidecar.write_axes_txt, jax_sidecar.write_axes_txt, (axes,),
              sidecar.read_axes_txt, jax_sidecar.read_axes_txt),
             ("p_8dir.txt", sidecar.write_8dir_txt, jax_sidecar.write_8dir_txt, (probs,),
              sidecar.read_8dir_txt, jax_sidecar.read_8dir_txt),
             ("s.txt", sidecar.write_single_peak_vm_txt, jax_sidecar.write_single_peak_vm_txt,
              (1.2345678901, 8.0), sidecar.read_single_peak_vm_txt,
              jax_sidecar.read_single_peak_vm_txt),
             ("m.txt", sidecar.write_multi_peak_vm_txt, jax_sidecar.write_multi_peak_vm_txt,
              (params, 2), sidecar.read_multi_peak_vm_txt, jax_sidecar.read_multi_peak_vm_txt))
    for name, write, jax_write, args, read, jax_read in cases:
        write(*args, tmp_path / name)
        jax_write(*args, tmp_path / ("jax_" + name))
        assert _same_bytes(tmp_path / name, tmp_path / ("jax_" + name)), name
        got, want = read(tmp_path / name), jax_read(tmp_path / name)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(sidecar.read_axes_txt(tmp_path / "axes.txt"), axes, atol=5e-7)
    assert sidecar.read_multi_peak_vm_txt(tmp_path / "m.txt")[1] == 2


@pytest.mark.parametrize("case", ["garbage", "short", "missing", "no_k", "k_over", "seven"])
def test_sidecar_failures_fall_back_as_jax(tmp_path, case):
    """The readers' failure defaults and errors, the port's beside JAX's."""
    text = {"garbage": "# mu(rad)\tkappa\nnot numbers\n", "short": "0.1 0.2 0.3\n1 2 3\n",
            "no_k": "# c\nmu(rad)\tkappa\tweight\n0.5\t8.0\t0.5\n-0.5\t8.0\t0.5\n",
            "k_over": "K 6\n" + "0.1 1 0.2\n" * 6, "seven": "0.1 " * 7 + "\n"}.get(case)
    path = tmp_path / "f.txt"
    if text is not None:
        path.write_text(text)
    for ours, theirs in ((sidecar.read_single_peak_vm_txt, jax_sidecar.read_single_peak_vm_txt),
                         (sidecar.read_axes_txt, jax_sidecar.read_axes_txt),
                         (sidecar.read_8dir_txt, jax_sidecar.read_8dir_txt),
                         (sidecar.read_multi_peak_vm_txt, jax_sidecar.read_multi_peak_vm_txt)):
        outcomes = []
        for fn in (ours, theirs):
            try:
                with np.testing.suppress_warnings() as sup:
                    sup.filter(UserWarning)
                    out = fn(path)
                outcomes.append(("ok", [np.asarray(x) for x in (out if isinstance(out, tuple)
                                                                else (out,))]))
            except Exception as e:  # the same exception type on both sides
                outcomes.append(("raise", type(e)))
        assert outcomes[0][0] == outcomes[1][0], (ours.__name__, outcomes)
        if outcomes[0][0] == "ok":
            for g, w in zip(outcomes[0][1], outcomes[1][1]):
                np.testing.assert_array_equal(g, w)
        else:
            assert outcomes[0][1] is outcomes[1][1]


# ---------- the native parser ----------

def test_native_parser_is_built_from_the_repo_source_and_matches_numpy(tmp_path, rng):
    assert fastply.native_available(), fastply.build_error()
    lib = fastply.build_library()
    assert lib.parent.parent == fastply.BUILD_ROOT and lib.name == "libfastply.so"
    assert fastply.SOURCE.samefile(os.path.join(os.path.dirname(__file__), os.pardir,
                                                "native", "fastply.cc"))
    paths = []
    for i in range(17):  # more files than pool threads
        p = tmp_path / f"c{i}.ply"
        ply.write_ply((rng.normal(size=(100 + 7 * i, 3)) * 10).astype(np.float32), p)
        paths.append(str(p))
    fastply.reset_parser_counts()
    bulk = fastply.try_read_ply_bulk_native(paths)
    assert fastply.parser_counts() == {"native": 17, "numpy": 0}
    for p, got in zip(paths, bulk):
        want = ply.read_ply_numpy(p)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(fastply.try_read_ply_native(p), want)
    assert fastply.try_read_ply_bulk_native([]) == []


def test_a_rejected_file_falls_back_to_numpy_alone(tmp_path, rng):
    """A PLY whose header declares no vertex property is rejected by the
    native parser and read by the NumPy one, in the bulk read of a tree
    too; the other files stay native, and the pack equals JAX's."""
    root = tmp_path / "tree"
    for cls in ("chair", "bottle"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            ply.write_ply(rng.normal(size=(50, 3)).astype(np.float32), root / cls / f"{i}.ply")
    odd = root / "chair" / "1.ply"
    lines = odd.read_text().splitlines()
    odd.write_text("\n".join(ln for ln in lines if not ln.startswith("property")) + "\n")
    assert fastply.try_read_ply_native(str(odd)) is None
    assert fastply.try_read_ply_bulk_native([str(odd)]) == [None]
    fastply.reset_parser_counts()
    ours = OrientationDataset.from_ply_tree(str(root), 32)
    assert fastply.parser_counts() == {"native": 5, "numpy": 1}
    theirs = JaxDataset.from_ply_tree(str(root), 32)
    np.testing.assert_array_equal(ours.points, theirs.points)
    np.testing.assert_array_equal(ours.labels, theirs.labels)


def test_a_parser_that_cannot_be_built_is_reported(tmp_path, monkeypatch, rng):
    """No source: a warning with the reason, ``build_error`` keeps it, every
    file goes to the NumPy parser and is counted there."""
    monkeypatch.setattr(fastply, "SOURCE", tmp_path / "missing.cc")
    monkeypatch.setattr(fastply, "_tried", False)
    monkeypatch.setattr(fastply, "_lib", None)
    monkeypatch.setattr(fastply, "_error", None)
    p = tmp_path / "c.ply"
    ply.write_ply(rng.normal(size=(20, 3)).astype(np.float32), p)
    fastply.reset_parser_counts()
    with pytest.warns(RuntimeWarning, match="missing.cc"):
        got = ply.read_ply(p)
    assert not fastply.native_available() and "missing.cc" in fastply.build_error()
    assert fastply.parser_counts() == {"native": 0, "numpy": 1}
    assert fastply.try_read_ply_bulk_native([str(p)]) is None
    np.testing.assert_array_equal(got, ply.read_ply_numpy(p))


# ---------- loaders ----------

def _assert_same_dataset(ours, theirs):
    np.testing.assert_array_equal(ours.points, theirs.points)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.class_names == theirs.class_names
    assert (ours.targets is None) == (theirs.targets is None)
    if ours.targets is not None:
        assert sorted(ours.targets) == sorted(theirs.targets)
        for k, v in theirs.targets.items():
            assert ours.targets[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours.targets[k], v, err_msg=k)
    for a in ("uniform_mask", "symm_mask", "k_spec"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(theirs, a))


@pytest.mark.parametrize("sidecars", [False, True])
def test_from_ply_tree_packs_as_jax_bit_for_bit(trees, sidecars):
    """Points (resampled by ``default_rng(0)``, up and down), labels and
    every stored target equal JAX's; the targets follow ``subset``,
    ``select_classes`` and ``split``."""
    _, rotated = trees
    for n in (128, 256):
        ours = OrientationDataset.from_ply_tree(rotated, n, load_sidecars=sidecars)
        theirs = JaxDataset.from_ply_tree(rotated, n, load_sidecars=sidecars)
        _assert_same_dataset(ours, theirs)
    _assert_same_dataset(ours.select_classes(["door", "chair"]),
                         theirs.select_classes(["door", "chair"]))
    for a, b in zip(ours.split(3), theirs.split(3)):
        _assert_same_dataset(a, b)
    if sidecars:
        assert ours.targets["mvm_k"].dtype == np.int32
        np.testing.assert_array_equal(ours.targets["forward"], ours.targets["axes"][:, 2])


def test_missing_sidecars_get_the_jax_defaults(trees, tmp_path):
    import shutil

    _, rotated = trees
    root = tmp_path / "partial"
    shutil.copytree(rotated, root)
    os.remove(root / "chair" / "chair_0.txt")
    os.remove(root / "chair" / "chair_1_8dir.txt")
    os.remove(root / "door" / "door_2_multi_peak_vM_gt.txt")
    (root / "door" / "door_3_single_peak_vM_gt.txt").write_text("# x\nnot a number\n")
    _assert_same_dataset(OrientationDataset.from_ply_tree(str(root), 64, load_sidecars=True),
                         JaxDataset.from_ply_tree(str(root), 64, load_sidecars=True))


def _write_h5(root, rng, id2file=True, layout="contiguous"):
    """Three archives of 64-point clouds: contiguous ``data`` and ``label``,
    or PointNet's ``save_h5`` layout (``data`` gzip 4 and ``label`` gzip 1,
    chunked as h5py picks) with ``normal`` and ``faceId`` beside them."""
    import h5py

    os.makedirs(root)
    names = ["airplane", "bottle", "chair"]
    (root / "shape_names.txt").write_text("\n".join(names) + "\n")
    for split, n, f in (("train", 5, "ply_data_train0.h5"), ("train", 4, "ply_data_train1.h5"),
                        ("test", 3, "ply_data_test0.h5")):
        data = rng.normal(size=(n, 64, 3)).astype(np.float32)
        label = rng.integers(0, 3, size=(n, 1)).astype(np.uint8)
        with h5py.File(root / f, "w") as h:
            if layout == "contiguous":
                h["data"], h["label"] = data, label
                continue
            h.create_dataset("data", data=data, compression="gzip", compression_opts=4)
            h.create_dataset("label", data=label, compression="gzip", compression_opts=1)
            normal = rng.normal(size=(n, 64, 3)).astype(np.float32)
            h.create_dataset("normal", data=normal, compression="gzip", compression_opts=4)
            h.create_dataset("faceId", data=rng.integers(0, 999, size=(n, 64), dtype=np.int32),
                             compression="gzip", compression_opts=4)
            assert h["data"].chunks and h["label"].compression == "gzip"
    if id2file:
        (root / "ply_data_train_0_id2file.json").write_text(
            json.dumps([f"airplane/plane_{i}.ply" for i in range(5)]))
        (root / "ply_data_test0_id2file.json").write_text(json.dumps({"1": "chair/chair_x"}))
    return names


@pytest.mark.parametrize("layout", ["contiguous", "pointnet_gzip"])
def test_hdf5_loader_and_tree_match_jax(tmp_path, rng, layout):
    """``load_modelnet_hdf5`` and ``from_hdf5`` (every archive, or one
    split) equal JAX's; ``hdf5_to_ply_tree`` writes the same tree, the
    ``id2file`` names (a list and a dict) included; on contiguous archives
    and on PointNet's chunked gzip layout with ``normal`` and ``faceId``."""
    root = tmp_path / "h5"
    _write_h5(root, rng, layout=layout)
    for splits in (("train", "test"), ("test",)):
        got = load_modelnet_hdf5(str(root), splits)
        want = jax_hdf5.load_modelnet_hdf5(str(root), splits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    _assert_same_dataset(OrientationDataset.from_hdf5(str(root)), JaxDataset.from_hdf5(str(root)))
    assert offline.hdf5_to_ply_tree(str(root), str(tmp_path / "ours")) == 12
    assert jax_offline.hdf5_to_ply_tree(str(root), str(tmp_path / "theirs")) == 12
    _assert_same_tree(tmp_path / "ours", tmp_path / "theirs")
    written = {f for _, _, files in os.walk(tmp_path / "ours") for f in files}
    assert {f"plane_{i}.ply" for i in range(5)} | {"chair_x.ply"} <= written


def _assert_same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files, cmp.report()
    for sub in cmp.common_dirs:
        _assert_same_tree(os.path.join(a, sub), os.path.join(b, sub))
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors, (a, mismatch, errors)


# ---------- offline tools ----------

def test_gt_generators_write_what_jax_writes(trees, tmp_path):
    """The three ground-truth passes on the same axes sidecars (yaw and
    SO(3) rotated): every file equal to the JAX tools' byte for byte."""
    import shutil

    canonical, _ = trees
    for mode in ("yaw", "so3"):
        src = tmp_path / mode
        offline.rotate_tree(canonical, str(src / "ours"), mode=mode, seed=5)
        shutil.copytree(src / "ours", src / "theirs")
        for tools, d in ((offline, src / "ours"), (jax_offline, src / "theirs")):
            assert tools.generate_8dir_gt(str(d)) == len(CLASSES) * PER_CLASS
            assert tools.generate_single_peak_gt(str(d)) == len(CLASSES) * PER_CLASS
            assert tools.generate_mvm_gt(str(d), str(d)) == len(CLASSES) * PER_CLASS
        _assert_same_tree(src / "ours", src / "theirs")


@pytest.mark.parametrize("mode", ["yaw", "so3"])
def test_rotate_tree_is_consistent_with_its_own_axes(trees, tmp_path, mode):
    """Each rotated cloud is its canonical cloud turned by the rotation
    whose image of the canonical axes its sidecar holds (to 1e-5); a yaw
    keeps the up axis; the seed fixes the draws."""
    canonical, _ = trees
    out = tmp_path / "r"
    assert offline.rotate_tree(canonical, str(out), mode=mode, seed=11) == 24
    canon_axes = np.asarray([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float64)
    for cls in CLASSES:
        for i in range(PER_CLASS):
            src = ply.read_ply(os.path.join(canonical, cls, f"{cls}_{i}.ply")).astype(np.float64)
            dst = ply.read_ply(out / cls / f"{cls}_{i}.ply").astype(np.float64)
            axes = sidecar.read_axes_txt(out / cls / f"{cls}_{i}.txt").astype(np.float64)
            rot = axes.T @ canon_axes  # R maps canonical axis a to axes row a
            np.testing.assert_allclose(dst, src @ rot.T, atol=1e-5)
            np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
            if mode == "yaw":
                np.testing.assert_allclose(axes[1], [0, 1, 0], atol=1e-6)
    again = tmp_path / "again"
    offline.rotate_tree(canonical, str(again), mode=mode, seed=11)
    _assert_same_tree(out, again)


def test_txt_tools_match_jax(tmp_path, rng):
    src = tmp_path / "txt"
    for cls in ("chair", "sofa"):
        (src / cls).mkdir(parents=True)
        for i in range(2):
            cols = 6 if i else 3
            np.savetxt(src / cls / f"{cls}_{i}.txt", rng.normal(size=(30, cols)), delimiter=",")
    (src / "sofa" / "one.txt").write_text("1.0,2.0,3.0\n")
    assert offline.txt_to_ply_tree(str(src), str(tmp_path / "ours")) == 5
    assert jax_offline.txt_to_ply_tree(str(src), str(tmp_path / "theirs")) == 5
    _assert_same_tree(tmp_path / "ours", tmp_path / "theirs")


# ---------- train steps on stored targets ----------

# preset -> (the JAX model's options, random_flax_variables options)
_STEPS = {"8dir_kl": ("pointnet_pp_8dir", {}), "mvm": ("pointnet_pp_mvm", {})}
B = 8


def _loader(trees):
    _, rotated = trees
    return (OrientationDataset.from_ply_tree(rotated, N, load_sidecars=True),
            JaxDataset.from_ply_tree(rotated, N, load_sidecars=True))


def _port_trainer(name, ds, **cfg):
    c = preset(name, batch_size=B, num_points=N, epochs=1, classes=CLASSES, grad_clip=None,
               **{"rotation_mode": "none", **cfg})
    return Trainer(c, ds, device="cpu", sampling="first", p_drop=0.0)


def _batches(trees, name):
    """The first train batch of the port's Trainer and of the JAX
    Trainer's ``_device_batch`` (the real method, on a stand-in holding its
    augment function, config and mesh) under ``rotation_mode="none"``."""
    ours_ds, theirs_ds = _loader(trees)
    trainer = _port_trainer(name, ours_ds)
    jcfg = jax_preset(name).replace(num_points=N, batch_size=B, classes=CLASSES,
                                    rotation_mode="none")
    stub = SimpleNamespace(cfg=jcfg, mesh=None,
                           augment=make_augment_fn(N, "none", jcfg.kappa_default, jcfg.max_k))
    theirs_train = theirs_ds.split(jcfg.seed)[0]
    idx, valid, _ = next(trainer.train_ds.batches(B, shuffle=True, seed=1))
    batch, valid_t, _ = trainer.device_batch(trainer.train_ds, idx, valid,
                                             trainer.generator(0, 1, 0))
    jbatch, _, _ = JaxTrainer._device_batch(stub, theirs_train, idx, valid,
                                            jax.random.PRNGKey(0))
    return trainer, batch, valid_t, {k: np.asarray(v) for k, v in jbatch.items()}, jcfg


def test_stored_targets_reach_the_batch_as_in_jax(trees):
    """Under ``rotation_mode="none"`` every stored target is the batch's,
    equal to the JAX trainer's batch bit for bit (points and labels too);
    under a yaw rotation they are ignored, as in JAX."""
    trainer, batch, _, jbatch, _ = _batches(trees, "8dir_kl")
    ds = trainer.train_ds
    idx, _, _ = next(ds.batches(B, shuffle=True, seed=1))
    for k, v in ds.targets.items():
        np.testing.assert_array_equal(batch[k].numpy(), v[idx], err_msg=k)
    for k in ("points", "labels", *ds.targets):
        np.testing.assert_array_equal(batch[k].numpy(), jbatch[k], err_msg=k)
    yaw = _port_trainer("8dir_kl", trainer.dataset, rotation_mode="yaw")
    ybatch, _, _ = yaw.device_batch(ds, idx, np.ones(B, np.float32), yaw.generator(0, 1, 0))
    assert not np.array_equal(ybatch["probs_8dir"].numpy(), ds.targets["probs_8dir"][idx])
    np.testing.assert_allclose(ybatch["axes"][:, 1].numpy(), np.tile([0, 1, 0], (B, 1)),
                               atol=1e-6)


_JAX = {}


def _norm_excess(got, want) -> float:
    """As in tests/test_torch_train_step.py."""
    excess = np.linalg.norm(got - want) - 1e-5 * np.sqrt(want.size)
    return float(max(excess, 0.0) / max(np.linalg.norm(want), 1e-30))


def _jax_step(name, v, pts, jbatch, valid, jcfg):
    """Loss, statistics and gradients of the JAX model's train step in
    float64, and its float32 loss (dropout the identity, centroids
    ``"first"``), as tests/test_torch_heads_train.py computes them."""
    if name in _JAX:
        return _JAX[name]
    model = JAX_MODELS[_STEPS[name][0]](sampling="first")
    adapter = jax_tasks.TASKS[jcfg.task]
    out = []
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, *a, **k: x):
        for dtype in (jnp.float64, jnp.float32):
            with jax.enable_x64(dtype == jnp.float64):
                cast = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, dtype if a.dtype == np.float32 else a.dtype),
                    {"v": v, "pts": pts, "batch": jbatch, "valid": valid})

                def loss_fn(params):
                    o, mut = model.apply({"params": params,
                                          "batch_stats": cast["v"]["batch_stats"]},
                                         cast["pts"], train=True, mutable=["batch_stats"])
                    per = adapter.loss(o, cast["batch"], jcfg)
                    w = cast["valid"]
                    return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0), mut["batch_stats"]

                (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                    cast["v"]["params"])
                out.append(jax.tree_util.tree_map(np.asarray, (loss, stats, grads)))
    _JAX[name] = (*out[0], out[1][0])
    return _JAX[name]


@pytest.mark.parametrize("name", list(_STEPS))
def test_train_step_on_stored_targets_matches_jax_f64_step(trees, name):
    """One port step of 8dir_kl and of mvm on a batch of the plygt tree
    (stored targets, ``rotation_mode="none"``) against the JAX float64 step
    on the JAX trainer's batch: the bounds of
    tests/test_torch_heads_train.py (loss within 1e-5 relative or the JAX
    float32 loss's own distance from float64, statistics within 2e-6, each
    gradient leaf within 3e-2 in ``_norm_excess``)."""
    trainer, batch, valid, jbatch, jcfg = _batches(trees, name)
    v = random_flax_variables(SEED, _STEPS[name][0])
    load_flax_variables(trainer.model, v)
    pts = batch["points"].numpy()
    want_loss, want_stats, want_grads, loss32 = _jax_step(name, v, pts, jbatch,
                                                          valid.numpy(), jcfg)
    m = trainer.train_step(batch, valid, None)
    rtol = max(1e-5, abs(float(loss32) - float(want_loss)) / abs(float(want_loss)))
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=rtol)
    leaves = jax.tree_util.tree_leaves_with_path
    got = to_flax_variables(trainer.model, grads=True)["params"]
    for (path, g), (_, w) in zip(leaves(got), leaves(want_grads)):
        assert np.isfinite(g).all() and _norm_excess(g, w) <= 3e-2, (
            jax.tree_util.keystr(path), _norm_excess(g, w))
    stats = to_flax_variables(trainer.model)["batch_stats"]
    assert len(leaves(stats)) == len(leaves(want_stats)) > 0
    for (path, g), (_, w) in zip(leaves(stats), leaves(want_stats)):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-6, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,key", [("8dir_kl", "probs_8dir"), ("mvm", "mvm_mu")])
def test_altered_stored_targets_move_the_loss(trees, name, key):
    """A planted fault: the same weights and clouds with one stored target
    altered (the 8-direction labels rolled by one direction, the mixture's
    means turned by 1 rad) give another loss, so the override is live; the
    loss of the unaltered tree is reproduced."""
    ds, _ = _loader(trees)
    altered = {**ds.targets}
    altered[key] = (np.roll(altered[key], 1, axis=-1) if key == "probs_8dir"
                    else altered[key] + np.float32(1.0))
    bad = OrientationDataset(ds.points, ds.labels, ds.class_names, altered)

    def loss(dataset):
        trainer = _port_trainer(name, dataset)
        load_flax_variables(trainer.model, random_flax_variables(SEED, _STEPS[name][0]))
        idx, valid, _ = next(trainer.train_ds.batches(B))
        batch, valid, _ = trainer.device_batch(trainer.train_ds, idx, valid,
                                               trainer.generator(0, 1, 0))
        return float(trainer.eval_step(batch, valid, None)["loss"])

    good = loss(ds)
    assert loss(ds) == good
    assert abs(loss(bad) - good) > 1e-3 * abs(good)


# ---------- artifacts and the CLI ----------

_DECODE_PRESETS = {"axes": ("axes_all_labels", {"rotation_mode": "so3", "classes": ("chair",)}),
                   "8dir_mse": ("8dir_mse", {}), "8dir_kl": ("8dir_kl", {}),
                   "forward_mse": ("pointnet_pp_forward", {"classes": ("chair",)}),
                   "multi_8dir": ("multi_8dir", {}), "vm_kl": ("vm_kl", {}), "mvm": ("mvm", {})}


@pytest.mark.parametrize("task", R.DECODED_TASKS)
def test_prediction_plys_parse_with_four_extra_vertices(trees, tmp_path, task):
    """Each decoded task's ``pred_ply`` files: ``read_ply`` gives the
    clouds plus 4 vertices (origin, then the decoded axes, which equal the
    JAX ``_decode_axes`` of the same outputs)."""
    name, kw = _DECODE_PRESETS[task]
    ds = OrientationDataset.synthetic(samples_per_class=20, num_points=256,
                                      class_names=list(kw.get("classes", CLASSES)))
    cfg = preset(name, batch_size=4, num_points=256, epochs=1, per_label=False,
                 **{"classes": CLASSES, **kw})
    assert cfg.task == task
    trainer = Trainer(cfg, ds, device="cpu", sampling="first")
    n = R.export_test_predictions(trainer, str(tmp_path), max_count=3)
    assert n == 3 and sorted(os.listdir(tmp_path)) == [f"sample_{i}_pred_{i + 1}.ply"
                                                       for i in range(3)]
    clouds = R._eval_batch(trainer, 3)["points"].numpy()
    outputs = trainer.predict(clouds)
    for i in range(3):
        got = ply.read_ply(tmp_path / f"sample_{i}_pred_{i + 1}.ply")
        assert got.shape == (256 + 4, 3) and not got[0].any()
        np.testing.assert_allclose(got[4:], clouds[i], atol=5e-7)
        # the 8-direction decode sums near-equal weighted directions at these
        # random weights: the two softmaxes' float32 rounding moves it by up to 3.3e-6
        want = jax_run._decode_axes(task, outputs, i)
        np.testing.assert_allclose(got[1:4], np.asarray(want, np.float32), atol=2e-5)


def test_classifier_exports_nothing(tmp_path):
    from pointcloud_orientation_tpu_torch.train import TrainConfig

    ds = OrientationDataset.synthetic(samples_per_class=6, num_points=512)
    trainer = Trainer(TrainConfig(task="classification", model="pointnet_pp_cls",
                                  batch_size=4, num_points=512), ds, device="cpu")
    assert R.export_test_predictions(trainer, str(tmp_path / "p")) == 0
    assert R._decode_axes("classification", None, 0) is None


def test_mvm_results_txt_matches_jax(tmp_path):
    hist = {"total": {"train": [3.0, 2.5], "val": [2.9, 2.4]},
            "chair": {"train": [1.0, 0.5], "val": [1.1, 0.25]}, "door": {"train": [], "val": []}}
    for write, name in ((M.write_mvm_results_txt, "ours"),
                        (jax_metrics.write_mvm_results_txt, "theirs")):
        write(str(tmp_path / name / "results.txt"), ["chair", "door"], hist, test_kl=2.125,
              best_val_epoch=2)
    assert _same_bytes(tmp_path / "ours" / "results.txt", tmp_path / "theirs" / "results.txt")


def test_cli_trains_on_stored_targets_and_writes_the_artifacts(trees, tmp_path, capsys):
    """``--data plygt:DIR`` trains with ``rotation_mode="none"`` and writes
    metrics, the summary with its two 8-direction lines, the prediction
    PLYs; ``--preset mvm`` writes ``results.txt``; ``ply:DIR`` and an
    unknown spec."""
    canonical, rotated = trees
    out = tmp_path / "kl"
    R.main(["--preset", "8dir_kl", "--data", f"plygt:{rotated}", "--epochs", "1",
            "--num-points", "128", "--batch-size", "8", "--device", "cpu", "--out", str(out),
            "--classes", ",".join(CLASSES)])
    m = json.loads((out / "metrics.json").read_text())
    assert m["config"]["rotation_mode"] == "none" and np.isfinite(m["test"]["loss"])
    lines = (out / "summary.txt").read_text().splitlines()
    assert lines[-3].startswith("Overall\t")
    assert [ln.split("\t")[0] for ln in lines[-2:]] == ["mean_gt_8dir", "mean_pred_8dir"]
    ds = OrientationDataset.from_ply_tree(rotated, 128, load_sidecars=True)
    test = ds.split(42)[2]
    gt = [float(x) for x in lines[-2].split("\t")[1].split()]
    np.testing.assert_allclose(gt, test.targets["probs_8dir"].mean(0), atol=5e-5)
    assert len(os.listdir(out / "pred_ply")) == min(10, len(test))
    R.main(["--preset", "mvm", "--data", f"plygt:{rotated}", "--epochs", "1",
            "--num-points", "128", "--batch-size", "8", "--device", "cpu",
            "--out", str(tmp_path / "mvm"), "--classes", ",".join(CLASSES)])
    results = (tmp_path / "mvm" / "results.txt").read_text().splitlines()
    assert results[0] == "=== Multi-Peak von Mises KL Summary ===" and len(results) == 9
    ply_ds = R.load_dataset(f"ply:{canonical}", 64)
    assert ply_ds.targets is None and ply_ds.points.shape == (24, 64, 3)
    with pytest.raises(ValueError):
        R.load_dataset("zip:/nowhere", 64)
    assert "[mvm] test loss" in capsys.readouterr().out
