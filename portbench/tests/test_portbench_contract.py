"""``BENCHMARK.json`` against the rules its readers hold it to, and every
file the harness finds by a name in it."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness, layer

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
END_TO_END = {e["name"]: e for e in BENCH["end_to_end"]}


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # every run of a full check fits: 2 + 14 runs a cell, 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_one_line_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and key != "source" or key == "source" and e in BENCH["configs"]:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_their_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCH["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in BENCH["end_to_end"])
    per = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == per for m in BENCH["per_layer"])


def test_metrics_sources_bounds_and_moves():
    assert "setup_s" in END_TO_END and END_TO_END["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in END_TO_END
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert w["chips"] in (1, 4)
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg["file"].startswith("portbench/") and (ROOT / cfg["file"]).is_file()
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    run = harness.load_run(cell, 1, 1.0, False, 0.0)
    assert run.limits, "a cell compares at least one number"
    reported = [m for m in BENCH["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert run.per_layer and all(m["moves"] in {r["name"] for r in reported}
                                 for m in run.per_layer)


def test_configurations_state_their_cuts():
    for c in BENCH["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert "assumed" in body and "precision" in body
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) or key == "batch_size"


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    run = harness.load_run("fwd8_train", 1, 1.0, True, 0.0)
    ctx = {"kind": "serve", "trace": {"busy_us": 1.0, "window_us": 2.0, "kernels": 3,
                                      "wrapper_us": {}}, "units": 1, "flops": 1.0,
           "window_s": 1.0, "calls": {}, "launches": {}}
    assert harness.read_layers(run, ctx) == {}
    ctx["kind"] = "train"
    got = harness.read_layers(run, ctx)
    assert got["device_idle_pct.train"]["value"] == 50.0
    assert "kernels_roofline.train" not in got


def test_kernels_roofline_reads_nothing_where_launches_differ_from_the_work():
    ctx = {"kind": "train", "trace": {"wrapper_us": {"fps": 2.0, "ball_query": 6.0}},
           "calls": {"fps": [1e-6], "ball_query": [1e-6, 2e-6]},
           "launches": {"fps": 1, "ball_query": 2, "knn": 0}}
    assert abs(layer.roofline_pct(ctx, "train") - 50.0) < 1e-9
    ctx["launches"]["ball_query"] = 3  # a kernel called once more than the work needs
    assert layer.roofline_pct(ctx, "train") is None
    ctx["launches"].update(ball_query=2, knn=1)  # a kernel the costs do not know
    assert layer.roofline_pct(ctx, "train") is None
