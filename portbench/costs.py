"""The yardstick's arithmetic: the H100's published peaks, the least time a
kernel call could take, the operations and bytes of each hand kernel from
its shapes, and the model FLOPs that ``mfu`` counts.

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates, at
the full 700 W): HBM3 at 3.35 TB/s; f32 outside the tensor cores at 67
TFLOP/s; TF32 in the tensor cores at 495 TFLOP/s, so an f32-grade product
run as 3xTF32 (three TF32 products of split operands, as the port's MLP
kernels run) at 495/3 = 165 TFLOP/s. Each cost function counts each input
byte read once and each output byte written once, and the operations that
the inputs need, whatever the kernel reads again or repeats.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_PRODUCT_FLOPS = PEAK_TF32_FLOPS / 3  # 3xTF32: the rate mfu is held to


def bound_s(nbytes: float, flops: float = 0.0, f32_products: float = 0.0) -> float:
    """The least seconds a call could take: the larger of its bytes at the
    memory peak and its operations (``flops`` at the f32 peak, integer
    operations too; ``f32_products`` at the 3xTF32 rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS + f32_products / PEAK_F32_PRODUCT_FLOPS
    return max(t_bytes, t_ops)


def sa_group_cost(B, N, S, Kn, D) -> Tuple[float, float]:
    """``sa_group``: bytes, and f32 operations: 8 per centroid-point
    distance, 5 per squared norm, 3 per centred neighbour."""
    nbytes = 4 * (B * N * 3 + B * N * D + B * S) + 4 * (B * S * 3 + B * Kn * S * (3 + D)
                                                        + B * S * Kn)
    return nbytes, 8 * B * S * N + 5 * B * N + 5 * B * S + 3 * B * Kn * S


def sa_mlp_cost(B, Kn, S, widths) -> Tuple[float, float, float]:
    """``sa_mlp_max``: bytes (grouped, the layers and the output), the
    elementwise operations (scale, shift, ReLU per activation, and the max)
    and the products' operations, apart."""
    rows = B * Kn * S
    pairs = list(zip(widths[:-1], widths[1:]))
    nbytes = 4 * (rows * widths[0] + sum(ci * co + 2 * co for ci, co in pairs)
                  + B * S * widths[-1])
    products = sum(2 * rows * ci * co for ci, co in pairs)
    rest = sum(3 * rows * co for _, co in pairs) + rows * widths[-1]
    return nbytes, rest, products


def scatter_cost(B, N, S, Kn, D) -> Tuple[float, float]:
    """``sa_group_scatter``: the cotangents and indices read, the rows
    written; one add per cotangent."""
    return 4 * (B * Kn * S * D + B * S * Kn + B * N * D), B * S * Kn * D


def fps_cost(B, N, npoint) -> Tuple[float, float]:
    """``fps``: the cloud and the seeds read, the indices written; 10
    operations per point for each of the ``npoint - 1`` updates."""
    return 4 * (B * N * 3 + B + B * npoint), 10 * B * N * (npoint - 1)


def ball_cost(B, S, N, Kn) -> Tuple[float, float]:
    """``ball_query``: cloud and centroids read, indices written; 9
    operations per point tested, counted at the least any input needs
    (``Kn`` points a centroid), so that the bound never exceeds the true
    one."""
    return 4 * (B * N * 3 + B * S * 3 + B * S * Kn), 9 * B * S * Kn


def stages(config: Dict, n_points: int) -> List[Dict]:
    """The set abstractions of ``config`` as they run on clouds of
    ``n_points``: each stage's centroids S, neighbours K, source points N,
    grouped width C0 (3 plus the features in), MLP widths, grouping kind
    (``knn``, ``ball`` or ``all``) and sampling."""
    out, n, feat = [], n_points, 0
    for st in config["model"]["sa"]:
        widths = [3 + feat, *st["mlp"]]
        if st.get("group_all"):
            out.append(dict(S=1, K=n, N=n, widths=widths, grouping="all", sampling=None))
        else:
            out.append(dict(S=st["npoint"], K=st["nsample"], N=n, widths=widths,
                            grouping=st["grouping"], sampling=st["sampling"],
                            radius=st.get("radius")))
            n = st["npoint"]
        feat = st["mlp"][-1]
    return out


def forward_flops(config: Dict, n_points: int) -> float:
    """Products' FLOPs of one cloud's forward: the shared MLPs over every
    neighbour row, the FC funnel and the head (2 per multiply-add)."""
    total = 0.0
    for st in stages(config, n_points):
        rows = st["S"] * st["K"]
        w = st["widths"]
        total += sum(2 * rows * ci * co for ci, co in zip(w[:-1], w[1:]))
    fc = [config["model"]["sa"][-1]["mlp"][-1], *config["model"]["fc"],
          config["model"]["classes_out"]]
    total += sum(2 * ci * co for ci, co in zip(fc[:-1], fc[1:]))
    return total


def kernel_calls(config: Dict, n_points: int, batch: int, train: bool
                 ) -> Dict[str, List[Tuple[float, float]]]:
    """The hand kernels one forward (and, with ``train``, its backward) of a
    batch launches, by the port's wrapper name, each call as ``(bytes,
    least seconds)``: the grouping (``sa_group`` for kNN up to 10,240
    points, with ``sa_group_scatter`` in the backward where the stage has
    features; ``fps`` and ``ball_query`` for the ball stages), and in eval
    the fused MLP+max (``sa_mlp_max``) of every stage. Train-mode MLPs run
    in cuBLAS, no hand kernel."""
    calls: Dict[str, List[Tuple[float, float]]] = {}

    def add(name, nbytes, flops=0.0, products=0.0):
        calls.setdefault(name, []).append((nbytes, bound_s(nbytes, flops, products)))

    for st in stages(config, n_points):
        B, S, K, N, w = batch, st["S"], st["K"], st["N"], st["widths"]
        D = w[0] - 3
        if st["grouping"] == "knn":
            add("sa_group", *sa_group_cost(B, N, S, K, D))
            if train and D:
                add("sa_group_scatter", *scatter_cost(B, N, S, K, D))
        elif st["grouping"] == "ball":
            add("fps", *fps_cost(B, N, S))
            add("ball_query", *ball_cost(B, S, N, K))
        if not train:
            nbytes, rest, products = sa_mlp_cost(B, K, S, w)
            add("sa_mlp_max", nbytes, rest, products)
    return calls


def merge_calls(parts: Iterable[Dict[str, List[Tuple[float, float]]]]
                ) -> Dict[str, List[Tuple[float, float]]]:
    out: Dict[str, List[Tuple[float, float]]] = {}
    for part in parts:
        for name, calls in part.items():
            out.setdefault(name, []).extend(calls)
    return out


def buckets(sizes: Sequence[int], max_batch: int) -> List[int]:
    """The predictor's batch bucket for each request size: the power of two
    from 1 up to it, clamped to ``max_batch``."""
    out = []
    for b in sizes:
        bucket = 1
        while bucket < b:
            bucket *= 2
        out.append(min(bucket, max_batch))
    return out
