"""The plain reference: PointNet++ from a configuration's sizes, in plain
PyTorch, float32 with TF32 off (or, for the control, on).

It imports nothing of the port and takes nothing the port made: the
benchmark hands it the clouds and the weights it handed the port, and it
works out again the split, the batch order, every random draw (from the
same seed derivation and in the same order, so that a cloud's subsample,
rotation, centroids, FPS starts and dropout masks are the ones the port
drew), the selections, the network, the loss, the gradients and Adam.

Selections are exact: each distance is formed in the order that defines
it, every product and sum rounded on its own (the kNN of a stage up to
10,240 points in the matmul form ``(c2 - 2 c.x) + x2``; FPS, and the ball
query from 1,024 to 20,480 points, in the difference form; the ball query
outside that range in the matmul form), with equal distances to the lowest
index, so that the reference picks the port's neighbours whenever the port
is right. Rotations use the products the task defines: the training batch
rotates by one batched ``einsum``, the serving views by the elementwise
form ``(r0 x + r1 y) + r2 z``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .costs import buckets, stages
from .weights import is_param

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax: running = 0.9 * running + 0.1 * batch
BALL_DIFF_RANGE = (1024, 20_480)  # the ball query's difference form, inclusive
TRAIN_STREAM, EVAL_STREAM = 0, 1
DIRS_8 = torch.tensor([[0.0, 0.0, -1.0], [0.70710678, 0.0, -0.70710678], [1.0, 0.0, 0.0],
                       [0.70710678, 0.0, 0.70710678], [0.0, 0.0, 1.0],
                       [-0.70710678, 0.0, 0.70710678], [-1.0, 0.0, 0.0],
                       [-0.70710678, 0.0, -0.70710678]])
UNIFORM_8DIR_CLASSES = ("bottle", "bowl", "plant")  # symmetric: the uniform 8-dir label


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Products in f32 (``tf32=False``) or TF32 within the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------- random draws


def keyed_generator(seed: int, stream: int, key: Sequence[int], device) -> torch.Generator:
    """The generator of a train step ``(epoch, step)`` or an eval batch
    ``(step,)``: seeded from ``SeedSequence([seed, stream, *key])``."""
    state = np.random.SeedSequence([seed, stream, *key]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def top_of_uniform(u: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` distinct positions per row of the uniforms ``u``: the largest,
    descending, equal values by position."""
    return torch.sort(u, dim=-1, descending=True, stable=True).indices[:, :k]


def split(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train, val and test rows: a permutation cut at 70% and 15%."""
    order = np.random.default_rng(seed).permutation(n)
    n_tr, n_va = int(0.7 * n), int(0.15 * n)
    return order[:n_tr], order[n_tr: n_tr + n_va], order[n_tr + n_va:]


def batches(n: int, batch: int, shuffle_seed: Optional[int]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A pass's ``(rows, valid)`` batches: rows in order (shuffled by
    ``shuffle_seed``), the last batch filled by wrapping around, its
    filling marked invalid."""
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    out = []
    for start in range(0, n, batch):
        rows = order[start: start + batch]
        valid = np.ones(len(rows), np.float32)
        if len(rows) < batch:
            pad = batch - len(rows)
            rows = np.concatenate([rows, np.tile(order, -(-pad // n))[:pad]])
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        out.append((rows, valid))
    return out


# ---------------------------------------------------------------- geometry


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def dist_matmul_form(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    s, d = src[:, :, None, :], dst[:, None, :, :]
    cross = (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1]) + s[..., 2] * d[..., 2]
    return (_sq_norm(src)[:, :, None] - 2.0 * cross) + _sq_norm(dst)[:, None, :]


def dist_diff_form(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    diff = src[:, :, None, :] - dst[:, None, :, :]
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, N, C)`` at ``idx (B, S)`` or ``(B, S, K)``."""
    B, _, C = x.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(x, 1, flat[:, :, None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def knn(centroids: torch.Tensor, xyz: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` nearest points (as a set) by the matmul-form distance,
    equal distances to the lowest index. Rows whose ``k``-th and
    ``k+1``-th distances are equal are settled by a stable sort."""
    d = dist_matmul_form(centroids, xyz)
    if k >= d.shape[-1]:
        return torch.sort(d, dim=-1, stable=True).indices[..., :k]
    vals, idx = torch.topk(d, k + 1, dim=-1, largest=False, sorted=True)
    tie = vals[..., k] == vals[..., k - 1]
    if bool(tie.any()):
        full = torch.sort(d[tie], dim=-1, stable=True).indices[..., :k + 1]
        idx = idx.clone()
        idx[tie] = full
    return idx[..., :k]


def ball(centroids: torch.Tensor, xyz: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """The ``k`` smallest indices within ``radius`` (squared in double,
    compared in f32, ``<=``), ascending, short rows filled with the first;
    ``N - 1`` where none lies within."""
    n = xyz.shape[1]
    matmul = not BALL_DIFF_RANGE[0] <= n <= BALL_DIFF_RANGE[1]
    d = (dist_matmul_form if matmul else dist_diff_form)(centroids, xyz)
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32, device=xyz.device)
    cols = torch.arange(n, device=xyz.device)
    cand = torch.where(d <= r2, cols, torch.full_like(cols, n))
    take = torch.sort(cand, dim=-1).values[..., :k]
    if k > n:
        take = torch.cat([take, torch.full((*take.shape[:-1], k - n), n, dtype=take.dtype,
                                           device=take.device)], dim=-1)
    take = torch.where(take == n, take[..., :1], take)
    return take.clamp(0, n - 1)


def fps(xyz: torch.Tensor, starts: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest points from ``starts``: each step lowers every point's
    least squared distance (from 1e10) and moves to the largest, equal
    values to the lowest index."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    far = starts.long()
    least = torch.full((B, N), 1e10, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        if i + 1 == npoint:
            break
        least = torch.minimum(least, dist_diff_form(xyz[rows, far][:, None], xyz)[:, 0])
        far = torch.argmax(least, dim=-1)
    return out


def yaw(theta: torch.Tensor) -> torch.Tensor:
    """Rotations about +y, ``(..., 3, 3)``."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


# ---------------------------------------------------------------- the network


class Net:
    """PointNet++ of a configuration over weights in the benchmark's layout
    (``weights.py``): set abstractions (sampling, grouping, shared MLP with
    BatchNorm and ReLU, max over neighbours), the FC funnel (BatchNorm,
    ReLU, dropout in training) and the head (raw logits or
    log-probabilities). BatchNorm in training takes flax's batch statistics
    (the biased variance ``max(0, E[x^2] - E[x]^2)`` over every leading
    axis) and updates the running ones as ``0.9 * old + 0.1 * batch``."""

    def __init__(self, config: Dict):
        self.config = config
        self.m = config["model"]

    def _bn(self, W, name, x, train, new_stats):
        if train:
            rows = x.reshape(-1, x.shape[-1])
            mean = rows.mean(0)
            var = torch.clamp_min((rows * rows).mean(0) - mean * mean, 0.0)
            if new_stats is not None:
                with torch.no_grad():
                    new_stats[f"{name}.mean"] = (BN_MOMENTUM * W[f"{name}.mean"]
                                                 + (1 - BN_MOMENTUM) * mean.detach())
                    new_stats[f"{name}.var"] = (BN_MOMENTUM * W[f"{name}.var"]
                                                + (1 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = W[f"{name}.mean"], W[f"{name}.var"]
        return (x - mean) / torch.sqrt(var + BN_EPS) * W[f"{name}.gamma"] + W[f"{name}.beta"]

    def draws(self, g: torch.Generator, rows: int, n_points: int, train: bool) -> List:
        """The model's random draws for a forward of ``rows`` clouds, in the
        order the forward makes them: each sampled stage's draw (one uniform
        a point, whose largest give the centroids, or an FPS start a
        cloud), then in training each dropout mask."""
        out = []
        for st in stages(self.config, n_points):
            if st["grouping"] == "all":
                continue
            if st["sampling"] == "random":
                out.append(torch.rand((rows, st["N"]), generator=g, device=g.device))
            else:
                out.append(torch.randint(0, st["N"], (rows,), generator=g, device=g.device,
                                         dtype=torch.int32))
        if train:
            for width, p in zip(self.m["fc"], self.m["fc_dropout"]):
                if p:
                    out.append(torch.rand((rows, width), generator=g, device=g.device) < 1.0 - p)
        return out

    def forward(self, W: Dict[str, torch.Tensor], x: torch.Tensor, draws: List, train: bool,
                new_stats: Optional[Dict] = None) -> torch.Tensor:
        xyz, feats, di = x, None, 0
        for i, st in enumerate(stages(self.config, x.shape[1])):
            if st["grouping"] == "all":
                grouped = xyz[:, None] if feats is None else torch.cat([xyz, feats], -1)[:, None]
            else:
                pick = draws[di]
                di += 1
                if st["sampling"] == "random":
                    cidx = top_of_uniform(pick, st["S"])
                else:
                    cidx = fps(xyz, pick, st["S"])
                centroids = gather_rows(xyz, cidx)
                if st["grouping"] == "knn":
                    idx = knn(centroids, xyz, st["K"])
                else:
                    idx = ball(centroids, xyz, st["radius"], st["K"])
                grouped = gather_rows(xyz, idx) - centroids[:, :, None]
                if feats is not None:
                    grouped = torch.cat([grouped, gather_rows(feats, idx)], -1)
                xyz = centroids
            h = grouped
            for j in range(len(st["widths"]) - 1):
                name = f"sa{i}.{j}"
                h = torch.relu(self._bn(W, name, h @ W[f"{name}.w"] + W[f"{name}.b"], train,
                                        new_stats))
            feats = h.amax(dim=2)
        h = feats.reshape(x.shape[0], -1)
        for j, p in enumerate(self.m["fc_dropout"]):
            name = f"fc{j}"
            h = torch.relu(self._bn(W, name, h @ W[f"{name}.w"] + W[f"{name}.b"], train,
                                    new_stats))
            if train and p:
                h = torch.where(draws[di], h / (1.0 - p), torch.zeros_like(h))
                di += 1
        out = h @ W["head.w"] + W["head.b"]
        return F.log_softmax(out, -1) if self.m["head"] == "log_softmax" else out


# ---------------------------------------------------------------- training


class TrainReference:
    """The training cell's reference: the split and batches of the trainer's
    protocol, the batch built on the device (subsample, yaw rotation, the
    8-dir soft label or the class label), the step (loss, gradients, Adam)
    and the val pass."""

    def __init__(self, config: Dict, seed: int, points: torch.Tensor, labels: torch.Tensor,
                 class_names: Sequence[str]):
        self.config, self.seed = config, seed
        self.net = Net(config)
        self.points, self.labels = points, labels
        uniform = torch.tensor([c in UNIFORM_8DIR_CLASSES for c in class_names],
                               device=points.device)
        self.uniform = uniform[labels]
        self.train_rows, self.val_rows, _ = split(points.shape[0], seed)
        self.batch = config["batch_size"]
        self.n_points = config["num_points"]

    def build(self, rows: np.ndarray, g: torch.Generator) -> Dict[str, torch.Tensor]:
        idx = torch.from_numpy(rows).to(self.points.device)
        pts = self.points.index_select(0, idx)
        B, M, _ = pts.shape
        if M > self.n_points:
            u = torch.rand((B, M), generator=g, device=pts.device)
            pick = top_of_uniform(u, self.n_points)
            pts = torch.gather(pts, 1, pick[..., None].expand(-1, -1, 3))
        rot = yaw(torch.rand((B,), generator=g, device=pts.device) * (2.0 * math.pi))
        pts = torch.einsum("bij,bnj->bni", rot, pts)
        fwd = -rot[:, :, 2]
        fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
        v = fwd / (torch.linalg.vector_norm(fwd, dim=-1, keepdim=True) + 1e-8)
        sims = (v[:, None, :] * DIRS_8.to(v.device)).sum(-1).clamp_min(0.0)
        total = sims.sum(-1, keepdim=True)
        probs = torch.where(total > 0, sims / torch.where(total > 0, total, torch.ones_like(total)),
                            torch.full_like(sims, 0.125))
        uni = self.uniform.index_select(0, idx)
        probs = torch.where(uni[:, None], torch.full_like(probs, 0.125), probs)
        return {"points": pts, "probs_8dir": probs, "labels": self.labels.index_select(0, idx)}

    def per_sample(self, out: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.config["task"] == "8dir_kl":
            return -(batch["probs_8dir"] * torch.log_softmax(out, -1)).sum(-1)
        return -torch.gather(out, 1, batch["labels"][:, None])[:, 0]

    def steps_from(self, W: Dict[str, torch.Tensor], steps: int, lr: float, epoch: int = 1,
                   count: int = 0, moments: Optional[Tuple[Dict, Dict]] = None,
                   half_batch: bool = False, jitter: float = 0.0) -> Dict:
        """``steps`` Adam steps from the start of ``epoch``, from the state
        ``W`` with Adam's ``count`` updates done and its first and second
        ``moments`` (zero where None): each step's loss, the first step's
        gradients and the state after the last step. ``half_batch`` is a
        planted fault: the loss is the mean over the first half of each
        batch only. ``jitter`` adds ``jitter * z`` times the leaf's root
        mean square to each gradient element (``z`` a normal drawn from
        ``step``): how far the later steps carry differences of round-off's
        size in the gradients."""
        params = {k: v.clone().requires_grad_(is_param(k)) for k, v in W.items()}
        keys = [k for k, v in params.items() if v.requires_grad]
        if moments is None:
            m = {k: torch.zeros_like(params[k]) for k in keys}
            v2 = {k: torch.zeros_like(params[k]) for k in keys}
        else:
            m = {k: moments[0][k].clone() for k in keys}
            v2 = {k: moments[1][k].clone() for k in keys}
        order = batches(len(self.train_rows), self.batch, self.seed + epoch)
        losses, first_grad = [], None
        for step in range(steps):
            rows, valid = order[step]
            g = keyed_generator(self.seed, TRAIN_STREAM, (epoch, step), self.points.device)
            batch = self.build(self.train_rows[rows], g)
            draws = self.net.draws(g, self.batch, self.n_points, train=True)
            new_stats: Dict[str, torch.Tensor] = {}
            out = self.net.forward(params, batch["points"], draws, True, new_stats)
            per = self.per_sample(out, batch)
            w = torch.from_numpy(valid).to(per.device)
            if half_batch:
                w[self.batch // 2:] = 0.0
            loss = (per * w).sum() / w.sum().clamp_min(1.0)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            if jitter:
                noise = torch.Generator(device=self.points.device).manual_seed(step)
                grads = [gr + jitter * gr.norm() / gr.numel() ** 0.5
                         * torch.randn(gr.shape, generator=noise, device=gr.device)
                         for gr in grads]
            if first_grad is None:
                first_grad = {k: gr.detach().clone() for k, gr in zip(keys, grads)}
            losses.append(float(loss.detach()))
            t = count + step + 1
            with torch.no_grad():
                for k, gr in zip(keys, grads):
                    m[k].mul_(0.9).add_(0.1 * gr)
                    v2[k].mul_(0.999).add_(0.001 * gr * gr)
                    mhat = m[k] / (1 - 0.9 ** t)
                    vhat = v2[k] / (1 - 0.999 ** t)
                    params[k] -= lr * mhat / (torch.sqrt(vhat) + 1e-8)
                for k, val in new_stats.items():
                    params[k] = val
        state = {k: v.detach() for k, v in params.items()}
        return {"losses": losses, "grad": first_grad, "state": state}

    @torch.no_grad()
    def val_pass(self, W: Dict[str, torch.Tensor]) -> Tuple[np.ndarray, np.ndarray]:
        """The val pass under ``W``: per-sample losses and the valid mask,
        each ``(batches, B)``."""
        per, valid = [], []
        for bi, (rows, v) in enumerate(batches(len(self.val_rows), self.batch, None)):
            g = keyed_generator(self.seed, EVAL_STREAM, (bi,), self.points.device)
            batch = self.build(self.val_rows[rows], g)
            draws = self.net.draws(g, self.batch, self.n_points, train=False)
            per.append(self.per_sample(self.net.forward(W, batch["points"], draws, False), batch))
            valid.append(v)
        return torch.stack(per).double().cpu().numpy(), np.stack(valid)

    def val_loss(self, W: Dict[str, torch.Tensor]) -> float:
        """The val pass's mean loss under ``W``, summed in float64."""
        per, valid = self.val_pass(W)
        return float((per * valid).sum() / max(valid.sum(), 1.0))


# ---------------------------------------------------------------- serving


class ServeReference:
    """The serving cell's reference: a request padded as the predictor pads
    it (points cycled or cut to ``num_points``, the batch filled to its
    power-of-two bucket with copies of the first cloud), the yaw views
    (``tta_views``, multiples of 45 degrees) in the elementwise rotation,
    the eval forward, and the views' combine (each view's softmax rolled
    back by its slots, averaged, logged), rows of the request only. Draws
    come from one generator seeded as the predictor's, replayed over every
    call in order."""

    def __init__(self, config: Dict, traffic: Dict, W: Dict[str, torch.Tensor], seed: int,
                 device, block: int = 64):
        self.config, self.W = config, W
        self.net = Net(config)
        self.views = traffic.get("tta_views", 1)
        self.max_batch = traffic["max_batch"]
        self.n_points = config["num_points"]
        self.g = torch.Generator(device=device)
        self.g.manual_seed(seed)
        self.device = device
        self.block = block
        step = 8 // self.views if self.views > 1 else 0
        angles = torch.tensor([i * step * math.pi / 4 for i in range(self.views)],
                              dtype=torch.float32).to(device)
        self.rots = yaw(angles)

    def bucket(self, b: int) -> int:
        return buckets([b], self.max_batch)[0]

    def pad(self, clouds: np.ndarray) -> torch.Tensor:
        b, n = clouds.shape[:2]
        if n < self.n_points:
            clouds = np.tile(clouds, (1, -(-self.n_points // n), 1))[:, : self.n_points]
        else:
            clouds = clouds[:, : self.n_points]
        bucket = self.bucket(b)
        if b < bucket:
            clouds = np.concatenate([clouds, np.repeat(clouds[:1], bucket - b, 0)], 0)
        return torch.from_numpy(np.ascontiguousarray(clouds, np.float32)).to(self.device)

    def draws(self, clouds: np.ndarray) -> List[torch.Tensor]:
        """The next call's draws, for a request of ``clouds``."""
        return self.net.draws(self.g, self.views * self.bucket(clouds.shape[0]), self.n_points,
                              train=False)

    @torch.no_grad()
    def outputs(self, clouds: np.ndarray, draws: List[torch.Tensor]) -> torch.Tensor:
        """One request's output from its call's ``draws``, in blocks of
        ``block`` views."""
        b = clouds.shape[0]
        rows = self.views * self.bucket(b)
        pts = self.pad(clouds)
        if self.views > 1:
            r = self.rots[:, None, None]
            v = pts[None]
            pts = ((r[..., 0] * v[..., 0:1] + r[..., 1] * v[..., 1:2])
                   + r[..., 2] * v[..., 2:3]).reshape(-1, *pts.shape[1:])
        outs = []
        for lo in range(0, rows, self.block):
            part = [d[lo: lo + self.block] for d in draws]
            outs.append(self.net.forward(self.W, pts[lo: lo + self.block], part, False))
        out = torch.cat(outs)
        if self.views > 1:
            step = 8 // self.views
            probs = torch.softmax(out, -1).reshape(self.views, -1, 8)
            back = torch.stack([torch.roll(probs[i], i * step, dims=-1)
                                for i in range(self.views)])
            out = torch.log(back.mean(0) + 1e-12)
        return out[:b]
