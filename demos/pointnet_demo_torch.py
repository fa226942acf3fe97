"""PointNet classifier smoke demo on the PyTorch/CUDA port: the 40-way
classifier with the feature transform, one forward on random clouds, the
NLL plus the feature transform's orthogonality penalty (the port of
``demos/pointnet_demo.py``).

    python demos/pointnet_demo_torch.py            # on the card
    python demos/pointnet_demo_torch.py --device cpu

Weights are random (flax's Dense initialisation, from a seed); the model
runs in eval. Its dense layers and transforms are cuBLAS products with TF32
off: PointNet reaches none of the port's kernels.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pointcloud_orientation_tpu_torch.losses import pointnet_cls_loss  # noqa: E402
from pointcloud_orientation_tpu_torch.models import PointNetCls  # noqa: E402
from pointcloud_orientation_tpu_torch.ops.cuda_kernels import f32_matmuls  # noqa: E402
from pointcloud_orientation_tpu_torch.train.trainer import flax_dense_init_  # noqa: E402


def demo(batch=8, num_points=1024, num_classes=40, device="cuda"):
    dev = torch.device(device)
    f32_matmuls()
    model = PointNetCls(num_classes=num_classes)
    flax_dense_init_(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, num_points, 3), generator=gen, device=dev)
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)
    with torch.no_grad():
        log_probs, trans_feat = model(x)
    loss, _ = pointnet_cls_loss(log_probs, labels, trans_feat)
    print(f"input {tuple(x.shape)} -> log_probs {tuple(log_probs.shape)}, "
          f"trans_feat {tuple(trans_feat.shape)}")
    print(f"classification loss (random weights): {float(loss):.4f} "
          f"(~ln {num_classes} = {math.log(num_classes):.4f})")
    return log_probs, trans_feat, loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    demo(device=ap.parse_args().device)
