"""Write the committed Orbax fixture that ``chip_smoke.py``'s ``orbax``
phase and ``tests/test_torch_orbax.py`` read without orbax: a checkpoint of
the JAX package's ``Trainer.save_checkpoint`` after one epoch of a narrow
point transformer (embed 32, 4 heads, 1 layer, feed-forward 64: the
widths that its tree fixes), and beside it ``leaves.npz`` with every array
leaf of orbax's own restore (keys are the ``/``-joined key paths;
``_none_paths`` lists the ``None`` leaves), a seeded batch of clouds and the
JAX predictor's outputs on them (``from_orbax_checkpoint``, XLA attention,
float32). Needs the JAX package, orbax and tensorstore; not collected as a
test. Run from the repository's root::

    JAX_PLATFORMS=cpu python tests/torch_make_orbax_fixture.py [OUT_DIR]

(default ``tests/data/orbax_transformer``; the directory is replaced).
"""

import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pointcloud_orientation_tpu_torch.utils.orbax_format import flat_leaves  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "orbax_transformer")
WIDTHS = {"embed_dim": 32, "num_heads": 4, "depth": 1, "ffn_dim": 64}
B, N, SEED = 4, 128, 0


def clouds():
    return np.random.default_rng(SEED).normal(size=(B, N, 3)).astype(np.float32)


def main(out_dir: str = DEFAULT_OUT) -> str:
    import orbax.checkpoint as ocp

    from pointcloud_orientation_tpu import models as jax_models
    from pointcloud_orientation_tpu import infer as jax_infer
    from pointcloud_orientation_tpu.data import OrientationDataset
    from pointcloud_orientation_tpu.models.point_transformer import PointTransformer
    from pointcloud_orientation_tpu.train import Trainer, preset
    from pointcloud_orientation_tpu.train import trainer as jax_trainer

    class NarrowPointTransformer(PointTransformer):
        embed_dim: int = WIDTHS["embed_dim"]
        num_heads: int = WIDTHS["num_heads"]
        depth: int = WIDTHS["depth"]
        ffn_dim: int = WIDTHS["ffn_dim"]

    registries = [jax_models.MODEL_REGISTRY, jax_trainer.MODEL_REGISTRY,
                  jax_infer.MODEL_REGISTRY]
    saved = [r["point_transformer"] for r in registries]
    for r in registries:
        r["point_transformer"] = NarrowPointTransformer
    try:
        ds = OrientationDataset.synthetic(samples_per_class=8, num_points=N,
                                          class_names=["chair"])
        cfg = preset("point_transformer", batch_size=B, num_points=N, epochs=1, seed=SEED)
        trainer = Trainer(cfg, ds)
        trainer.fit(epochs=1, log_every=0)
        shutil.rmtree(out_dir, ignore_errors=True)
        path = trainer.save_checkpoint(out_dir)
        with ocp.PyTreeCheckpointer() as ckptr:
            restored = ckptr.restore(path)
        predictor = jax_infer.OrientationPredictor.from_orbax_checkpoint(
            path, "point_transformer", num_points=N, max_batch=B)
        x = clouds()
        outputs = np.asarray(predictor(x), np.float32)
    finally:
        for r, cls in zip(registries, saved):
            r["point_transformer"] = cls
    leaves = flat_leaves(restored)
    arrays = {k: np.asarray(v) for k, v in leaves if v is not None}
    nones = np.asarray([k for k, v in leaves if v is None], dtype=str)
    np.savez_compressed(os.path.join(out_dir, "leaves.npz"), _none_paths=nones, _clouds=x,
             _outputs=outputs, _step=np.asarray(int(trainer.state.step)),
             **{f"leaf:{k}": v for k, v in arrays.items()})
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out_dir) for f in fs)
    print(f"wrote {path} and leaves.npz: {len(arrays)} arrays, {len(nones)} None leaves, "
          f"{size} bytes in all")
    return path


if __name__ == "__main__":
    main(*sys.argv[1:])
