"""The rank side of ``tests/test_torch_parallel_*.py``: the port's parallel
paths run as ``gloo`` process groups on the CPU.

:func:`run_ranks` starts ``world`` processes of this file for each world
size (all at once), each pinned to one thread; every rank joins the group,
runs one suite of checks and rank 0 pickles the suite's results (numpy
arrays and numbers) for the test, which holds them against the JAX package
on its virtual mesh. This module imports neither JAX nor the JAX package,
so a rank starts with torch alone. The inputs are made with numpy from
seeds by the functions below, which the tests call too.

    python tests/torch_parallel_ranks.py SUITE WORLD PORT OUT RANK
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_SIZE = dict(embed_dim=16, num_heads=4, ffn_dim=32)  # the JAX parallel tests' transformer
SP_LR = 1e-2  # the JAX SP test's SGD rate


# ---------- inputs (numpy, shared with the tests) ----------

def transformer_inputs(seed: int = 0, B: int = 8, N: int = 24, depth: int = 2):
    """A flax PointTransformer tree (dropout-free sizes of the JAX tests),
    clouds and targets."""
    from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables

    rng = np.random.default_rng(seed + 100)
    v = random_flax_variables(seed, "point_transformer", depth=depth, **T_SIZE)
    return (v["params"], rng.normal(size=(B, N, 3)).astype(np.float32),
            rng.normal(size=(B, 3)).astype(np.float32))


def moe_inputs(seed: int = 0, B: int = 4, N: int = 24, E: int = 16, F: int = 32, K: int = 4):
    rng = np.random.default_rng(seed)
    params = {"router": {"kernel": (rng.standard_normal((E, K)) / np.sqrt(E)).astype(np.float32)},
              "wi": (rng.standard_normal((K, E, F)) / np.sqrt(E)).astype(np.float32),
              "bi": (0.1 * rng.standard_normal((K, F))).astype(np.float32),
              "wo": (rng.standard_normal((K, F, E)) / np.sqrt(F)).astype(np.float32),
              "bo": (0.1 * rng.standard_normal((K, E))).astype(np.float32)}
    return (params, rng.normal(size=(B, N, E)).astype(np.float32),
            rng.normal(size=(B, E)).astype(np.float32))


def qkv_inputs(seed: int = 0, B: int = 8, H: int = 2, N: int = 64, D: int = 16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(4))


def ring_model_inputs(seed: int = 0, B: int = 4, N: int = 32):
    from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables

    rng = np.random.default_rng(seed + 7)
    v = random_flax_variables(seed, "ring_point_transformer", embed_dim=16, num_heads=2,
                              depth=2, ffn_dim=32)
    return (v["params"], rng.normal(size=(B, N, 3)).astype(np.float32),
            rng.normal(size=(B, 3)).astype(np.float32))


def clouds(seed: int, B: int, N: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


def small_dataset(samples_per_class: int = 8, num_points: int = 256):
    from pointcloud_orientation_tpu_torch.data import OrientationDataset

    return OrientationDataset.synthetic(samples_per_class=samples_per_class,
                                        num_points=num_points)


DP_CONFIGS = {  # name -> (preset, overrides, Trainer kwargs)
    # the JAX test's DP configuration (tests/test_resume_and_parallel.py)
    "simple_pointnet": ("simple_pointnet", dict(classes=("chair", "sofa")), {}),
    # PointNet++ with BatchNorm in every layer; 11 train clouds: a partial last batch
    "8dir_kl": ("8dir_kl", dict(classes=("chair", "sofa")), {}),
    "8dir_kl_fused": ("8dir_kl", dict(classes=("chair", "sofa")), {"fused_mlp_train": True}),
}


def dp_trainer(name: str, mesh=None):
    from pointcloud_orientation_tpu_torch.train import Trainer, preset

    p, over, kw = DP_CONFIGS[name]
    cfg = preset(p, num_points=128, batch_size=8, epochs=1, optimizer="sgd", **over)
    return Trainer(cfg, small_dataset(), device="cpu", mesh=mesh, **kw)


def dp_epoch(name: str, mesh=None) -> Dict:
    """One epoch of a DP configuration: its weights and statistics and its
    history."""
    t = dp_trainer(name, mesh)
    t.fit(epochs=1, log_every=0)
    state = {k: v.detach().numpy().copy() for k, v in t.model.state_dict().items()}
    return {"state": state, "history": t.history}


# One step of the JAX Trainer's DP configuration made deterministic, as the
# protocol tests make it (tests/test_torch_protocols.py): no dropout, the first
# points as centroids, clouds of exactly num_points (no subsample) and no
# rotation, so both frameworks run one function. SGD at lr 1: the step moves each
# weight by its gradient, which the JAX side reads back as p0 - p1. Ten chairs
# split 7/1/2: one train step on a batch of 8 with one padded row. Both sides run
# in float64 (the port through the kernels' plain versions), the trunk's output
# rounded to float32 as the JAX trunk casts it; host_resident takes the JAX
# Trainer's step-by-step epoch (its whole-epoch scan carries float32 scalars).
JAX_STEP_CFG = dict(num_points=128, batch_size=8, epochs=1, rotation_mode="none",
                    optimizer="sgd", lr=1.0, host_resident=True)
JAX_STEP_WEIGHTS = 5  # random_flax_variables' seed: both frameworks start from it


def jax_step_dataset(module):
    """The step's dataset from ``module`` (either package's ``data``)."""
    return module.OrientationDataset.synthetic(samples_per_class=10, num_points=128,
                                               class_names=["chair"])


def dp_jax_step(mesh=None) -> Dict:
    """The port's side of the JAX DP step: the Trainer's one epoch (one
    step) in float64 from the shared weights; the weights, statistics and
    gradient of the step as flax trees, and the history."""
    import contextlib
    from unittest import mock

    from pointcloud_orientation_tpu_torch import data
    from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
    from pointcloud_orientation_tpu_torch.train import Trainer, preset
    from pointcloud_orientation_tpu_torch.train import trainer as TR
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    random_flax_variables,
                                                                    to_flax_variables)

    v = random_flax_variables(JAX_STEP_WEIGHTS)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            TR, "flax_dense_init_", lambda model, generator: load_flax_variables(model, v)))
        for name in ("sa_group", "sa_group_scatter", "sa_mlp_max"):  # any float dtype
            stack.enter_context(mock.patch.object(K, name, getattr(K, f"{name}_plain")))
        t = Trainer(preset("8dir_kl", **JAX_STEP_CFG), jax_step_dataset(data), device="cpu",
                    mesh=mesh, sampling="first", p_drop=0.0)
        t.model.double()
        t.model.trunk.register_forward_hook(lambda module, args, out: out.float().double())
        to_batch = t.device_batch

        def device_batch(*a, **k):
            batch, valid, labels = to_batch(*a, **k)
            return ({n: x.double() if x.is_floating_point() else x for n, x in batch.items()},
                    valid.double(), labels)

        t.device_batch = device_batch
        t.fit(epochs=1, log_every=0)
    after = to_flax_variables(t.model)
    return {"params": after["params"], "batch_stats": after["batch_stats"],
            "grads": to_flax_variables(t.model, grads=True)["params"],
            "history": t.history, "steps": t.step}


# One step of the MoE point transformer's capacity dispatch under DP, against the
# JAX Trainer on its virtual mesh (tests/test_torch_moe_dp.py): the DP step's
# deterministic configuration above on the preset's task (forward_mse_aux), at
# the port's MoE test sizes with no dropout, at a capacity factor that drops
# tokens and at n_experts, which drops none. The global batch is 8 clouds of 128
# points: 1,024 tokens, 320 slots an expert at 1.25.
MOE_SIZE = dict(depth=2, embed_dim=16, num_heads=2, ffn_dim=32)
MOE_FACTORS = (1.25, 4.0)
MOE_STEP_CFG = dict(JAX_STEP_CFG, moe_dispatch="capacity")
MOE_STEP_WEIGHTS = 6


def moe_step_weights() -> Dict:
    from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables

    return random_flax_variables(MOE_STEP_WEIGHTS, "moe_point_transformer", **MOE_SIZE)


@contextlib.contextmanager
def recorded_slots(rank: int, factor: float):
    """Record each capacity dispatch's kept tokens (``ep.slot_tokens``'s
    table) as global token ids (rank ``r``'s ``T`` tokens follow the lower
    ranks'), and the tokens that the rank's batch would keep laid out
    alone (its own capacity at ``factor``, its own counts), one array each
    a call."""
    from unittest import mock

    from pointcloud_orientation_tpu_torch.parallel import ep

    real, kept, alone = ep.slot_tokens, [], []

    def slot_tokens(assign, n_experts, capacity, before=None):
        slots = real(assign, n_experts, capacity, before)
        T = assign.numel()
        kept.append(np.sort(slots[slots < T].cpu().numpy()) + rank * T)
        own = real(assign, n_experts, ep.expert_capacity(T, n_experts, factor))
        alone.append(np.sort(own[own < T].cpu().numpy()) + rank * T)
        return slots

    with mock.patch.object(ep, "slot_tokens", slot_tokens):
        yield kept, alone


def moe_dp_step(factor: float, mesh=None) -> Dict:
    """The port's side of the JAX MoE DP step: the Trainer's one epoch (one
    step) of the capacity dispatch in float64 from the shared weights; the
    step's loss, aux loss, gradient and each layer's kept tokens (global
    ids, every rank's), and each rank's kept tokens had it laid out its
    own batch alone."""
    from unittest import mock

    from pointcloud_orientation_tpu_torch import data
    from pointcloud_orientation_tpu_torch.train import Trainer, preset
    from pointcloud_orientation_tpu_torch.train import trainer as TR
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    to_flax_variables)

    v = moe_step_weights()
    rank = 0 if mesh is None else _rank()
    aux = []
    with mock.patch.object(TR, "flax_dense_init_",
                           lambda model, generator: load_flax_variables(model, v)), \
            recorded_slots(rank, factor) as (kept, alone):
        t = Trainer(preset("moe_point_transformer", **MOE_STEP_CFG, moe_capacity_factor=factor),
                    jax_step_dataset(data), device="cpu", mesh=mesh, dropout=0.0, **MOE_SIZE)
        t.model.double()
        t.model.register_forward_hook(
            lambda module, args, out: aux.append(float(out[1].detach())))
        to_batch = t.device_batch

        def device_batch(*a, **k):
            batch, valid, labels = to_batch(*a, **k)
            return ({n: x.double() if x.is_floating_point() else x for n, x in batch.items()},
                    valid.double(), labels)

        t.device_batch = device_batch
        t.fit(epochs=1, log_every=0)
    depth = MOE_SIZE["depth"]  # the step's forward comes first, one dispatch a layer
    every = _gather_objects((kept[:depth], alone[:depth])) if mesh is not None else [
        (kept[:depth], alone[:depth])]
    return {"loss": t.history["train"][0], "aux": aux[0], "steps": t.step,
            "grads": to_flax_variables(t.model, grads=True)["params"],
            "kept": [np.concatenate([r[0][i] for r in every]) for i in range(depth)],
            "kept_alone": [np.concatenate([r[1][i] for r in every]) for i in range(depth)]}


def moe_fsdp(mesh) -> Dict:
    """An FSDP step (``make_fsdp_train_step``) of the MoE transformer's
    regression output under the capacity dispatch at a dropping factor,
    and the same SGD step on one rank's whole batch without FSDP, in
    float64, with each layer's kept tokens."""
    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.models import MoEPointTransformer
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    to_flax_variables)

    class Regression(MoEPointTransformer):  # the FSDP step's loss takes one output
        def forward(self, x, generator=None):
            return super().forward(x, generator)[0]

    def model():
        return load_flax_variables(Regression(dropout=0.0, dispatch="capacity", **MOE_SIZE),
                                   moe_step_weights()).double()

    x = torch.from_numpy(clouds(16, 8, 64)).double()
    target = torch.from_numpy(np.random.default_rng(17).normal(size=(8, 3))).double()
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
    rows = P.batch_sharding(mesh).rows(8)
    out = {}
    m = model()
    fp = P.shard_fsdp_params(m, mesh, min_weight_size=1)
    with recorded_slots(_rank(), 1.25) as (kept, _):
        fp, _, loss = P.make_fsdp_train_step(m, mesh)(fp, sgd(fp.parameters()), x[rows],
                                                       target[rows])
    out["fsdp"] = {"loss": float(loss), "params": to_flax_variables(fp.unshard())["params"],
                   "kept": [np.concatenate(k) for k in zip(*_gather_objects(kept))]}
    ref = model()
    with recorded_slots(0, 1.25) as (kept, _):
        ref_loss = ((ref(x) - target) ** 2).mean()
    ref_loss.backward()
    sgd(ref.parameters()).step()
    out["one_device"] = {"loss": float(ref_loss), "params": to_flax_variables(ref)["params"],
                         "kept": kept}
    return out


def suite_moe_dp(world: int) -> Dict:
    from pointcloud_orientation_tpu_torch import parallel as P

    mesh = P.make_mesh(("data",), device="cpu")
    return {"step": {f: moe_dp_step(f, mesh) for f in MOE_FACTORS}, "fsdp": moe_fsdp(mesh)}


def serving_predictor(mesh=None, sampling: str = "random"):
    from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
    from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables

    v = random_flax_variables(3)
    return OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                num_points=256, max_batch=8, seed=1, device="cpu", mesh=mesh,
                                sampling=sampling)


# ---------- suites (run on every rank) ----------

def _gather_objects(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def suite_mesh(world: int) -> Dict:
    import torch
    import torch.distributed as dist

    from pointcloud_orientation_tpu_torch import parallel as P

    res: Dict = {}
    mesh = P.make_mesh(("data",), device="cpu")
    batch = np.arange(world * 2 * 5, dtype=np.float32).reshape(world * 2, 5)
    local = P.shard_batch({"x": torch.from_numpy(batch)}, mesh)["x"]
    res["shards"] = _gather_objects(local.numpy())
    res["axis_size"] = P.data_axis_size(mesh)
    t = torch.full((3,), float(dist.get_rank()))
    P.replicate({"t": t}, mesh)
    res["replicated"] = _gather_objects(t.numpy())
    two = P.make_mesh(("data", "model"), (-1, 2), device="cpu")
    res["two_axes"] = (two.mesh.tolist(), two["data"].size(), two["model"].size())
    hybrid = P.make_hybrid_mesh(("data", "model"), (-1, 2), (1, 1), device="cpu")
    res["hybrid"] = hybrid.mesh.tolist()
    dcn = P.make_hybrid_mesh(("data", "model"), (world // 2, 1), (1, 2), device="cpu")
    res["hybrid_dcn"] = dcn.mesh.tolist()
    errors = []
    for call in (lambda: P.make_mesh(("data",), (world + 1,), device="cpu"),
                 lambda: P.make_hybrid_mesh(("data",), (world + 1,), (1,), device="cpu"),
                 lambda: P.make_hybrid_mesh(("data", "model"), (world,), (1, 1), device="cpu"),
                 lambda: P.process_local_slice(world * 2 + 1),
                 lambda: P.make_mesh(("data",), backend="nccl", device="cpu")):
        try:
            call()
            errors.append(None)
        except Exception as e:  # noqa: BLE001 - the test reads the class and message
            errors.append((type(e).__name__, str(e)))
    res["errors"] = errors
    res["local_slice"] = _gather_objects(P.process_local_slice(world * 4))
    g = P.global_batch_from_local(mesh, batch[P.batch_sharding(mesh).rows(len(batch))])
    res["global_batch"] = (tuple(g.shape), g.full_tensor().numpy())
    P.initialize_multihost()  # a group is up: a no-op
    return res


def suite_dp(world: int) -> Dict:
    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.ops.batch_shard import batch_shard
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    random_flax_variables,
                                                                    to_flax_variables)

    mesh = P.make_mesh(("data",), device="cpu")
    res: Dict = {"epochs": {name: dp_epoch(name, mesh) for name in DP_CONFIGS},
                 "jax_step": dp_jax_step(mesh)}
    # the 8-dir model's train forward on the global batch: logits and statistics
    from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir

    v = random_flax_variables(5)
    model = load_flax_variables(PointNetPP8Dir(sampling="first", p_drop=0.0), v).train()
    x = torch.from_numpy(clouds(11, 8, 128))
    sharding = P.batch_sharding(mesh)
    with torch.no_grad(), batch_shard(sharding):
        logits = model(x[sharding.rows(8)], None)
    from pointcloud_orientation_tpu_torch.parallel.comm import all_gather_cat

    res["train_forward"] = {"logits": all_gather_cat(logits, sharding.group).numpy(),
                            "batch_stats": to_flax_variables(model)["batch_stats"]}
    # sharded serving: a request of 5 (bucket 8 over 2 or 4 ranks), random and first sampling
    req = clouds(12, 5, 300)
    res["serve"] = {s: serving_predictor(mesh, s)(req) for s in ("random", "first")}
    big = clouds(13, 13, 300)  # above max_batch=8: two chunks
    res["serve_chunks"] = serving_predictor(mesh, "first")(big)
    try:
        serving_predictor_tta(mesh)
        res["serve_tta_error"] = None
    except ValueError as e:
        res["serve_tta_error"] = str(e)
    return res


def serving_predictor_tta(mesh):
    from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
    from pointcloud_orientation_tpu_torch.utils.jax_weights import random_flax_variables

    v = random_flax_variables(3)
    return OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"],
                                device="cpu", mesh=mesh, tta_views=2)


def suite_protocols(world: int) -> Dict:
    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.train import preset
    from pointcloud_orientation_tpu_torch.train.ensemble import run_per_label_vmapped
    from pointcloud_orientation_tpu_torch.train.multiseed import run_multi_seed
    from pointcloud_orientation_tpu_torch.train.protocol_ckpt import read_protocol_carry

    mesh = P.make_mesh(("data",), device="cpu")
    ds = small_dataset(samples_per_class=8, num_points=128)
    cfg = protocol_config()
    out = tempfile.mkdtemp(prefix=f"pcot_protocols_{world}_") if _rank() == 0 else None
    out = _gather_objects(out)[0]
    res: Dict = {}
    seeds = list(range(1, world + 1))
    ms = run_multi_seed(cfg, ds, seeds, mesh=mesh, device="cpu", log_every=0,
                        checkpoint_dir=os.path.join(out, "ms_ckpt"), return_params=True,
                        out_dir=os.path.join(out, "ms"))
    res["multi_seed"] = ms
    labels = list(ds.class_names[:world])
    res["per_label"] = run_per_label_vmapped(cfg, ds, labels=labels, mesh=mesh, device="cpu",
                                             log_every=0,
                                             checkpoint_dir=os.path.join(out, "pl_ckpt"))
    if _rank() == 0:
        carry = read_protocol_carry(os.path.join(out, "ms_ckpt", "step_1"))
        res["carry_seeds"] = [c["seed"] for c in carry["configs"]]
        res["carry_members"] = len(carry["members"])
        res["files"] = sorted(os.listdir(os.path.join(out, "ms")))
    try:
        run_multi_seed(cfg, ds, seeds[:-1] or [1], mesh=mesh, device="cpu", log_every=0)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    _gather_objects(None)  # every rank is done with the files
    if _rank() == 0:
        shutil.rmtree(out, ignore_errors=True)
    return res


def protocol_config():
    from pointcloud_orientation_tpu_torch.train import preset

    return preset("8dir_kl", num_points=128, batch_size=4, epochs=2, checkpoint_every=1)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def suite_fsdp_tp(world: int) -> Dict:
    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.models import PointTransformer
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    to_flax_variables,
                                                                    transformer_kwargs)

    params, x, target = transformer_inputs()
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731

    def model():
        return load_flax_variables(PointTransformer(**transformer_kwargs(params), dropout=0.0),
                                   {"params": params})

    res: Dict = {"fsdp": {}, "tp": {}}
    mesh = P.make_mesh(("data",), device="cpu")
    sharding = P.batch_sharding(mesh)
    xs, ts = (torch.from_numpy(a[sharding.rows(len(a))]) for a in (x, target))
    for remat in (False, True):
        m = model()
        fp = P.shard_fsdp_params(m, mesh, min_weight_size=1)
        opt = sgd(fp.parameters())
        shard_shapes = {k: tuple(p.shape) for k, p in fp.shards.items()}
        fp, opt, loss = P.make_fsdp_train_step(m, mesh, remat=remat)(fp, opt, xs, ts)
        res["fsdp"][remat] = {"loss": float(loss),
                              "params": to_flax_variables(fp.unshard())["params"],
                              "shard_shapes": shard_shapes}
    try:
        m = model()
        fp = P.shard_fsdp_params(m, mesh)
        P.make_fsdp_train_step(m, mesh, train=True)(fp, sgd(fp.parameters()), xs, ts)
        res["fsdp_train_error"] = None
    except ValueError as e:
        res["fsdp_train_error"] = str(e)
    # the PointNet++ trunk through its kernels' plain versions, in train mode
    res["fsdp_pp"] = fsdp_pointnet_pp(mesh)
    shapes = [(1, world), (world // 2, 2)] if world > 2 else [(1, world)]
    for n_data, n_model in shapes:
        tmesh = P.make_mesh(("data", "model"), (n_data, n_model), device="cpu")
        ts_ = P.batch_sharding(tmesh)
        for impl in ("xla", "flash"):
            if impl == "flash":
                p2, x2, t2 = transformer_inputs(B=4, N=128)
                full = load_flax_variables(PointTransformer(**transformer_kwargs(p2), dropout=0.0,
                                                            attention_impl="flash"),
                                           {"params": p2})
            else:
                p2, x2, t2 = params, x, target
                full = model()
            tp = P.shard_tp_params(full, tmesh)
            opt = sgd(tp.parameters())
            xr, tr = (torch.from_numpy(a[ts_.rows(len(a))]) for a in (x2, t2))
            tp, opt, loss = P.make_tp_train_step(tmesh)(tp, opt, xr, tr)
            res["tp"][(n_data, n_model, impl)] = {
                "loss": float(loss), "params": to_flax_variables(tp.unshard(full))["params"]}
    return res


def fsdp_pointnet_pp(mesh) -> Dict:
    """An FSDP step of the 8-dir model in train mode (BatchNorm over the
    global batch, first-point sampling, no dropout), and the same step on
    one rank's whole batch without FSDP, for the test to compare; in
    float64, the grouping through its plain versions (the wrappers take
    float32)."""
    from unittest import mock

    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir
    from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    random_flax_variables,
                                                                    to_flax_variables)

    v = random_flax_variables(9)
    x = torch.from_numpy(clouds(14, 8, 128)).double()
    target = torch.from_numpy(np.random.default_rng(15).normal(size=(8, 8))).double()
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.05)  # noqa: E731
    out = {}
    sharding = P.batch_sharding(mesh)
    with mock.patch.object(K, "sa_group", K.sa_group_plain), \
            mock.patch.object(K, "sa_group_scatter", K.sa_group_scatter_plain):
        return _fsdp_pointnet_pp(mesh, v, x, target, sgd, sharding, out)


def _fsdp_pointnet_pp(mesh, v, x, target, sgd, sharding, out):
    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.models import PointNetPP8Dir
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    to_flax_variables)

    m = load_flax_variables(PointNetPP8Dir(sampling="first", p_drop=0.0), v).double()
    fp = P.shard_fsdp_params(m, mesh, min_weight_size=1)
    gen = torch.Generator().manual_seed(0)
    rows = sharding.rows(8)
    fp, _, loss = P.make_fsdp_train_step(m, mesh, train=True)(
        fp, sgd(fp.parameters()), x[rows], target[rows], gen)
    out["fsdp"] = {"loss": float(loss), **to_flax_variables(fp.unshard())}
    ref = load_flax_variables(PointNetPP8Dir(sampling="first", p_drop=0.0), v).double().train()
    opt = sgd(ref.parameters())
    y = ref(x, None)
    ref_loss = ((y - target) ** 2).mean()
    ref_loss.backward()
    opt.step()
    out["one_device"] = {"loss": float(ref_loss), **to_flax_variables(ref)}
    return out


def suite_pp_ep(world: int) -> Dict:
    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.models import PointTransformer
    from pointcloud_orientation_tpu_torch.parallel.ep import MoEFeedForward
    from pointcloud_orientation_tpu_torch.parallel.pp import split_pipeline_params
    from pointcloud_orientation_tpu_torch.utils.jax_weights import to_flax_variables

    res: Dict = {"pp": {}, "ep": {}}
    params, x, target = transformer_inputs(depth=4)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
    stacked, rest = split_pipeline_params(params, 4)
    layouts = [(None, world, 2), (None, world, 4)]
    if world == 4:
        layouts.append((2, 2, 2))
    for n_data, stages, microbatches in layouts:
        if n_data is None:
            mesh = P.make_mesh(("stage",), device="cpu")
            xs, ts = torch.from_numpy(x), torch.from_numpy(target)
        else:
            mesh = P.make_mesh(("data", "stage"), (n_data, stages), device="cpu")
            rows = P.batch_sharding(mesh).rows(len(x))
            xs, ts = torch.from_numpy(x[rows]), torch.from_numpy(target[rows])
        stage = P.place_pipeline_state(stacked, rest, mesh)
        out = P.make_pp_apply(microbatches)(stage, xs)
        stage, _, loss = P.make_pp_train_step(
            mesh, microbatches, data_axis=None if n_data is None else "data")(
                stage, sgd(stage.parameters()), xs, ts)
        local = PointTransformer(depth=len(stage.layers), dropout=0.0, **T_SIZE)
        local.load_state_dict(stage.state_dict())
        res["pp"][(n_data, stages, microbatches)] = {
            "apply": out.numpy(), "loss": float(loss),
            "stage": _gather_objects(to_flax_variables(local)["params"])}
    mesh = P.make_mesh(("expert",), device="cpu")
    mparams, mx, mtarget = moe_inputs()
    for dispatch in ("masked", "capacity"):
        mod = MoEFeedForward(16, 32, 4, dispatch=dispatch, capacity_factor=4.0)
        placed = {k: v.requires_grad_() for k, v in P.place_ep_params(mparams, mesh).items()}
        apply = P.make_ep_apply(mod, mesh)
        xt = torch.from_numpy(mx)
        y, aux = apply(placed, xt)
        loss = ((y.mean(dim=1) - torch.from_numpy(mtarget)) ** 2).mean() + 0.01 * aux
        loss.backward()
        new = {k: (v - 0.1 * v.grad).detach().numpy() for k, v in placed.items()}
        res["ep"][dispatch] = {"y": y.detach().numpy(), "aux": float(aux),
                               "new": _gather_objects(new)}
    return res


def suite_ring_sp(world: int) -> Dict:
    import torch

    from pointcloud_orientation_tpu_torch import parallel as P
    from pointcloud_orientation_tpu_torch.utils.jax_weights import (load_flax_variables,
                                                                    ring_kwargs,
                                                                    to_flax_variables)

    res: Dict = {"ring": {}, "sp": {}}
    q, k, v, do = qkv_inputs()
    shapes = [(world // sp, sp) for sp in (2, 4) if world % sp == 0]
    for n_data, sp in shapes:
        mesh = P.make_mesh(("data", "model"), (n_data, sp), device="cpu")
        bd, sd = P.batch_sharding(mesh, "data"), P.batch_sharding(mesh, "model")

        def local(a):
            return torch.from_numpy(a[bd.rows(a.shape[0])][:, :, sd.rows(a.shape[2])].copy())

        for cd in (None, torch.bfloat16):
            qs, ks, vs = (local(a).requires_grad_() for a in (q, k, v))
            out = P.make_ring_attention(mesh, compute_dtype=cd)(qs, ks, vs)
            (out * local(do)).sum().backward()
            res["ring"][(n_data, sp, str(cd))] = _gather_objects(
                {"out": out.detach().numpy(), "dq": qs.grad.numpy(), "dk": ks.grad.numpy(),
                 "dv": vs.grad.numpy(), "data": bd.rank, "model": sd.rank})
        rp, rx, rt = ring_model_inputs()
        model = load_flax_variables(P.RingPointTransformer(**ring_kwargs(rp)), {"params": rp})
        xs = torch.from_numpy(rx[bd.rows(len(rx))][:, sd.rows(rx.shape[1])].copy())
        tt = torch.from_numpy(rt[bd.rows(len(rt))])
        with torch.no_grad():
            fwd = model(xs, group=mesh.get_group("model"))
        step = P.make_sp_train_step(mesh)
        model, _, loss = step(model, torch.optim.SGD(model.parameters(), lr=SP_LR), xs, tt)
        res["sp"][(n_data, sp)] = {"forward": _gather_objects((bd.rank, fwd.numpy())),
                                   "loss": float(loss),
                                   "params": to_flax_variables(model)["params"]}
    return res


SUITES = {"mesh": suite_mesh, "dp": suite_dp, "protocols": suite_protocols,
          "fsdp_tp": suite_fsdp_tp, "pp_ep": suite_pp_ep, "ring_sp": suite_ring_sp,
          "moe_dp": suite_moe_dp}


# ---------- launching ----------

def run_ranks(suite: str, worlds: Sequence[int] = (2, 4), timeout: float = 600) -> Dict[int, Dict]:
    """Run ``suite`` at each world size (all ranks of all sizes at once)
    and return rank 0's results by world size; raises with the ranks'
    output when one fails."""
    from pointcloud_orientation_tpu_torch.parallel.mesh import free_port

    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    tmp = tempfile.mkdtemp(prefix=f"pcot_ranks_{suite}_")
    procs = []
    for world in worlds:
        port, out = free_port(), os.path.join(tmp, f"world{world}.pkl")
        for rank in range(world):
            log = open(os.path.join(tmp, f"world{world}_rank{rank}.log"), "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite, str(world), str(port), out,
                 str(rank)], env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)))
    failed = []
    for world, rank, log, p in procs:
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((world, rank, rc))
    if failed:
        logs = ""
        for world, rank, _ in failed:
            with open(os.path.join(tmp, f"world{world}_rank{rank}.log")) as f:
                logs += f"--- world {world} rank {rank}\n{f.read()[-4000:]}\n"
        raise RuntimeError(f"ranks failed {failed}:\n{logs}")
    results = {}
    for world in worlds:
        with open(os.path.join(tmp, f"world{world}.pkl"), "rb") as f:
            results[world] = pickle.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return results


def main(argv: Sequence[str]) -> None:
    suite, world, port, out, rank = argv
    world, rank = int(world), int(rank)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        results = SUITES[suite](world)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
