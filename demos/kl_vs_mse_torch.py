"""MSE against KL on probability distributions, in the port (the port of
``demos/kl_vs_mse.py``, the runnable edition of the reference's
``kl.ipynb``).

Shows why the 8-direction task uses a soft-label KL objective: MSE treats a
mass shift to an adjacent and to an opposite compass bin alike, KL does
not. Prints the same numbers as ``demos/kl_vs_mse.py``.

    python demos/kl_vs_mse_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from pointcloud_orientation_tpu_torch.losses import soft_label_kl_8dir


def main():
    target = torch.tensor([[0.7, 0.3, 0, 0, 0, 0, 0, 0.0]])
    # two predictions with the SAME MSE to the target: mass moved to the
    # adjacent bin, or to the opposite one
    adjacent = torch.tensor([[0.5, 0.5, 0, 0, 0, 0, 0, 0.0]])
    opposite = torch.tensor([[0.5, 0.3, 0, 0, 0.2, 0, 0, 0.0]])

    def mse(p):
        return float(((p - target) ** 2).mean())

    def kl(p):
        # KL(P||Q) with the target as P (the training objective, up to the
        # constant entropy term)
        logits = torch.log(torch.clamp_min(p, 1e-9))
        _, per = soft_label_kl_8dir(logits, target)
        return float(per[0])

    print(f"{'prediction':<12} {'MSE':>10} {'CE=KL+H(P)':>12}")
    for name, p in [("adjacent", adjacent), ("opposite", opposite)]:
        print(f"{name:<12} {mse(p):>10.5f} {kl(p):>12.5f}")
    print("\nMSE barely distinguishes the two errors; the cross-entropy "
          "penalizes mass on bins the target gives zero probability.")


if __name__ == "__main__":
    main()
