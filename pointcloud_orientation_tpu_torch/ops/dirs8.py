"""8-direction compass basis and projections.

Eight horizontal unit vectors at 45-degree steps, clockwise from the
canonical forward ``[0, 0, -1]`` (``DIRS_8`` of the reference's
`models/pointnet_pp_8dir.py:46-55`).
"""

from __future__ import annotations

import torch

_S = 0.70710678
DIRS_8 = torch.tensor(
    [
        [0.0, 0.0, -1.0],  # 0    (forward)
        [_S, 0.0, -_S],    # 45
        [1.0, 0.0, 0.0],   # 90
        [_S, 0.0, _S],     # 135
        [0.0, 0.0, 1.0],   # 180
        [-_S, 0.0, _S],    # 225
        [-1.0, 0.0, 0.0],  # 270
        [-_S, 0.0, -_S],   # 315
    ],
    dtype=torch.float32,
)


def forward_to_8dir_probs(forward: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Project forward vectors ``(..., 3)`` to 8-direction probabilities:
    normalize, dot with the basis, clamp at 0, renormalize; an all-zero
    response becomes the uniform distribution."""
    v = forward / (torch.linalg.vector_norm(forward, dim=-1, keepdim=True) + eps)
    sims = (v[..., None, :] * DIRS_8.to(v.device, v.dtype)).sum(-1).clamp_min(0.0)
    total = sims.sum(-1, keepdim=True)
    uniform = torch.full_like(sims, 0.125)
    return torch.where(total > 0, sims / torch.where(total > 0, total, torch.ones_like(total)), uniform)
