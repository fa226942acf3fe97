"""What every cell's run shares: finding the cell and its files by name,
the seeds drawn from ``--seed``, the comparison's readings against their
limits, the per-layer readers, and the result line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pointcloud_orientation_tpu")


@dataclasses.dataclass
class Run:
    """One run of one cell: its entries in ``BENCHMARK.json``, its
    configuration and traffic files, and the command's arguments."""

    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    per_layer: List[Dict]
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Seconds from the run's start to the end of a set-up phase."""
        self.marks[phase] = time.perf_counter() - self.t0

    def seed_for(self, purpose: str) -> int:
        """A 31-bit seed of ``--seed`` for one purpose (weights, clouds,
        trainer, predictor, pool, sample)."""
        words = [int(b) for b in purpose.encode()]
        return int(np.random.SeedSequence([self.seed, *words]).generate_state(1)[0]) >> 1


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_run(name: str, seed: int, seconds: float, trace: bool, t0: float,
             root: Path = ROOT) -> Run:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root`` with its
    configuration, traffic (``portbench/traffic/<traffic>.json``), limits
    (``portbench/checks/<cell>.json``) and the per-layer metrics it
    reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    workload = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    config = load_json(root / config_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{workload['traffic']}.json")
    limits_path = HERE / "checks" / f"{name}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    reported = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"]}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Run(workload, config, traffic, limits, per_layer, seed, seconds, trace, t0)


def end_to_end_names(root: Path = ROOT) -> Dict[str, Dict]:
    return {m["name"]: m for m in load_json(root / "BENCHMARK.json")["end_to_end"]}


def read_layers(run: Run, ctx: Dict) -> Dict[str, Dict]:
    """Each per-layer metric of the cell from its reader
    ``portbench/metrics/<name>.py`` (``read(ctx)``, None where it finds
    nothing to read, and then left out)."""
    out = {}
    for metric in run.per_layer:
        path = HERE / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def leaf_gap(prog: Dict, ref: Dict, keys: List[str], over=max) -> float:
    """Each leaf's gap between the program's and the reference's norm, over
    the larger of that leaf's reference norm and the median leaf's; the
    worst of them (``over=max``) or another statistic of them."""
    if not keys:
        return 0.0
    ref_norms = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(ref_norms.values())
    return over([abs(float(prog[k].double().norm()) - ref_norms[k])
                 / max(ref_norms[k], med, 1e-30) for k in keys])


UNREAD = 1e300  # a number the run could not read (a missing or non-finite reading)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number the cell compares (every key of its limits) beside its
    limit; a number the run could not read is ``UNREAD``, and fails."""
    out = {}
    for k, lim in limits.items():
        value = float(readings.get(k, UNREAD))
        out[k] = {"value": value if np.isfinite(value) else UNREAD, "limit": lim}
    return out


def correct(checks: Dict[str, Dict]) -> bool:
    """Every compared number finite and within its limit; a cell with no
    limits is not correct."""
    return bool(checks) and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in checks.values())


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, compared
    by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: Dict, checks: Dict[str, Dict], readings: Dict[str, float]) -> None:
    """The readings the cell does not compare, then the numbers compared
    as the last lines of standard error; the result as the last line of
    standard output, its ``checks`` last."""
    for name in sorted(set(readings) - set(checks)):
        print(f"reading {name} {readings[name]!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
