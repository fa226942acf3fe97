"""PointNet++ classifier smoke demo on the PyTorch/CUDA port: farthest-point
sampling and the radius ball query through the port's kernels, then the
NLL of random labels (the port of ``demos/pointnet_pp_demo.py``).

    python demos/pointnet_pp_demo_torch.py            # on the card
    python demos/pointnet_pp_demo_torch.py --device cpu

Weights are random (flax's Dense initialisation, from a seed); the model
runs in eval, its FPS starts drawn from a generator, as the JAX demo draws
them from its ``sampling`` key.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pointcloud_orientation_tpu_torch.losses import nll_loss  # noqa: E402
from pointcloud_orientation_tpu_torch.models import PointNetPPCls  # noqa: E402
from pointcloud_orientation_tpu_torch.train.trainer import flax_dense_init_  # noqa: E402


def demo(batch=4, num_points=1024, num_classes=40, with_normals=True, device="cuda"):
    dev = torch.device(device)
    channels = 6 if with_normals else 3
    model = PointNetPPCls(num_classes=num_classes, in_channels=channels)
    flax_dense_init_(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, num_points, channels), generator=gen, device=dev)
    labels = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)
    with torch.no_grad():
        log_probs = model(x, torch.Generator(device=dev).manual_seed(4))
    loss, _ = nll_loss(log_probs, labels)
    print(f"input {tuple(x.shape)} (FPS + radius ball-query SA) -> {tuple(log_probs.shape)}")
    print(f"NLL (random weights): {float(loss):.4f}")
    return log_probs, loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    demo(device=ap.parse_args().device)
