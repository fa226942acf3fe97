"""The serving cells: ``OrientationPredictor.__call__`` under an open loop:
requests arrive at the traffic's fixed rate (Poisson, :func:`.synth.arrivals`)
and are served one at a time in arrival order, from a pool drawn in set-up
and sent in the pool's order again and again. A request due while the
predictor is busy waits; one due while it is idle is sent at its time.

Set-up makes the weights and a bank of clouds from the seed, builds the
predictor, draws the pool, and warms up each batch bucket the pool uses.
The window serves until ``--seconds`` have passed and counts the clouds
answered; each call is timed from the call to the numpy result on the
host (its service time), and from the time it was due.
After it, the reference replays the predictor's random draws over every
call in order and recomputes a sample of the window's answers drawn from
the seed, the largest request among them.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from pointcloud_orientation_tpu_torch.infer import OrientationPredictor

from .. import costs, synth, trace, weights
from ..harness import Run
from ..reference import ServeReference, precision


def make_predictor(run: Run, tree: Dict) -> OrientationPredictor:
    t = run.traffic
    return OrientationPredictor(run.config["predictor"]["model"], tree["params"],
                                tree["batch_stats"], num_points=run.config["num_points"],
                                max_batch=t["max_batch"], tta_views=t["tta_views"],
                                seed=run.seed_for("predictor"), device=run.device)


def run(run: Run) -> Dict:
    cfg, traffic = run.config, run.traffic
    dev = torch.device(run.device)
    W, pool = make_inputs(run)
    run.mark("inputs")
    predictor = make_predictor(run, weights.to_flax(cfg, W))
    run.mark("program")
    sent: List[int] = []  # pool index of every call, warm-up included
    by_bucket = {}
    for i, req in enumerate(pool):
        by_bucket.setdefault(costs.buckets([req.shape[0]], traffic["max_batch"])[0], i)
    for i in sorted(by_bucket.values()):
        predictor(pool[i])
        sent.append(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.mark("warm_up")
    setup_s = time.perf_counter() - run.t0

    due_at = synth.arrivals(traffic["rate_per_s"], run.seconds, run.seed_for("arrivals"))
    service, late, answers, failed = [], [], [], 0
    w0 = time.perf_counter()
    j = 0
    while j < len(due_at) and due_at[j] < run.seconds and time.perf_counter() - w0 < run.seconds:
        due = w0 + due_at[j]
        if time.perf_counter() < due:
            time.sleep(due - time.perf_counter())
        i = j % len(pool)
        t = time.perf_counter()
        try:
            out = predictor(pool[i])
        except RuntimeError:
            failed += 1
            out = None
        service.append(time.perf_counter() - t)
        late.append(t - due)
        answers.append((len(sent), out))
        sent.append(i)
        j += 1
    window_s = time.perf_counter() - w0
    clouds = sum(pool[i].shape[0] for i in sent[len(sent) - j:])
    metrics = {"serve_clouds_per_s": clouds / window_s, "setup_s": setup_s}
    load = {"offered_per_s": traffic["rate_per_s"], "served_per_s": j / window_s,
            "service_p95_ms": float(np.percentile(np.asarray(service) * 1e3, 95)),
            "due_p95_ms": float(np.percentile((np.asarray(service) + late) * 1e3, 95)),
            "late_last_s": late[-1]}
    layer_ctx = None
    if run.trace:
        layer_ctx = traced_requests(run, predictor, pool, sent)
        views = traffic["tta_views"]
        layer_ctx.update(flops=clouds * views * costs.forward_flops(cfg, cfg["num_points"]),
                         window_s=window_s, service_s=service)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del predictor
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    picks = sample_calls(run, [pool[sent[k]].shape[0] for k, _ in answers])
    readings = compare(run, W, pool, sent, dict(answers[p] for p in picks))
    return {"attempted": j, "failed": failed, "metrics": metrics, "memory_peak_bytes": peak,
            "layer_ctx": layer_ctx, "readings": readings, "load": load}


def sample_calls(run: Run, sizes: List[int]) -> set:
    """Which of the calls (clouds each in ``sizes``) the reference
    recomputes: ``check`` of them drawn from the seed, and the first of the
    largest."""
    rng = np.random.default_rng(run.seed_for("sample"))
    picks = {int(x) for x in rng.choice(len(sizes), min(run.traffic["check"], len(sizes)),
                                        replace=False)}
    return picks | {int(np.argmax(sizes))} if sizes else picks


def traced_requests(run: Run, predictor: OrientationPredictor, pool: List[np.ndarray],
                    sent: List[int]) -> Dict:
    """The pool once more, in its order, under the profiler."""

    def requests():
        for i, req in enumerate(pool):
            predictor(req)
            sent.append(i)

    red, launches = trace.profile(requests, torch.device(run.device))
    cfg, t = run.config, run.traffic
    calls = costs.merge_calls(
        costs.kernel_calls(cfg, cfg["num_points"], t["tta_views"] * bucket, False)
        for bucket in costs.buckets([r.shape[0] for r in pool], t["max_batch"]))
    return {"kind": "serve", "trace": red, "units": len(pool), "launches": launches,
            "calls": {k: [least for _, least in v] for k, v in calls.items()}}


def compare(run: Run, W, pool, sent, outs) -> Dict[str, float]:
    """``out_gap``: the widest gap between a sampled answer and the
    reference's, over every row and output of the sampled requests
    (log-probabilities of the 8 directions or of the 40 classes); an
    answer that never came reads infinite."""
    ref = ServeReference(run.config, run.traffic, W, run.seed_for("predictor"),
                         torch.device(run.device))
    if not outs:
        return {"out_gap": float("inf")}
    gap, last = 0.0, max(outs)
    with precision(False):
        for k, i in enumerate(sent[: last + 1]):
            draws = ref.draws(pool[i])
            if k not in outs:
                continue
            got = outs[k]
            if got is None:
                return {"out_gap": float("inf")}
            want = ref.outputs(pool[i], draws)
            gap = max(gap, float((torch.from_numpy(got).to(want.device) - want).abs().max()))
    return {"out_gap": gap}


def make_inputs(run: Run):
    """The cell's weights and request pool, made on the device from the
    seed."""
    cfg, traffic = run.config, run.traffic
    dev = torch.device(run.device)
    W = weights.make_weights(cfg, run.seed_for("weights"), dev, serving=True)
    counts = [(c, traffic["bank_per_class"]) for c, _ in cfg["data"]["classes"]]
    bank, _, _ = synth.clouds(counts, traffic["points"][1], run.seed_for("clouds"), dev)
    return W, synth.request_pool(traffic, bank, run.seed_for("pool"))


def control(run: Run) -> Dict[str, Dict[str, float]]:
    """The cell's control at its own size, on its seed's inputs: the
    reference in TF32 put in the program's place against the reference in
    f32, on the requests a run samples (drawn from the same seed), each
    call's draws taken once for both."""
    W, pool = make_inputs(run)
    ref = ServeReference(run.config, run.traffic, W, run.seed_for("predictor"),
                         torch.device(run.device))
    gap = 0.0
    for i in sorted(sample_calls(run, [r.shape[0] for r in pool])):
        draws = ref.draws(pool[i])
        with precision(False):
            want = ref.outputs(pool[i], draws)
        with precision(True):
            got = ref.outputs(pool[i], draws)
        gap = max(gap, float((got - want).abs().max()))
    return {"tf32": {"out_gap": gap}}
