"""The readings that a cell's limits are set from, in one process: the
program's on each of ``--seeds`` (the cell's own run, with a short
window), then the control's and the planted faults' at the cell's own
size on each of ``--control-seeds`` (each entry's ``control``); for a
serving cell, with ``--rates``, the sweep that finds its knee: one run a
rate (requests a second offered, the traffic's own rate replaced), what was
served and how late. One JSON line per run:

    python3 portbench/calibrate.py --workload CELL --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--rates 40,80,120] [--seconds 1]

The benchmark's own runs never call this; it needs a CUDA device.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.run import set_environment

    set_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    rates = [("rate", float(r)) for r in args.rates.split(",") if r]
    seeds = [(kind, int(s)) for kind, given in (("program", args.seeds),
                                                 ("control", args.control_seeds))
             for s in given.split(",") if s]
    for kind, value in seeds + rates:
        t0 = time.perf_counter()
        run = harness.load_run(args.workload, 1 if kind == "rate" else value, args.seconds,
                               False, t0)
        entry = importlib.import_module(f"portbench.entries.{run.traffic['entry']}")
        if kind == "control":
            line = {"readings": entry.control(run)}
        else:
            if kind == "rate":
                run.traffic["rate_per_s"] = value
            out = entry.run(run)
            line = {"readings": out["readings"], "metrics": out["metrics"],
                    "load": out.get("load")}
        line.update(kind=kind, workload=args.workload, value=value,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
