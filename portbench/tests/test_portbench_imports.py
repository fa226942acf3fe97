"""No JAX: nothing the harness imports has a top-level module name of
``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax`` or
``pointcloud_orientation_tpu``, compared whole; and the yardstick's own
modules (the reference among them) import nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"


def test_everything_the_harness_runs_loads_no_jax():
    code = (
        "import json, sys, importlib.util, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness, reference, costs, synth, weights, trace, layer\n"
        "from portbench.entries import fit, serve\n"
        "from portbench import run, calibrate\n"
        f"for p in sorted(pathlib.Path({str(HERE / 'metrics')!r}).glob('*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pointcloud_orientation_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pointcloud_orientation_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "pointcloud_orientation_tpu.fake", object())
    assert harness.forbidden_modules() == ["jaxlib", "pointcloud_orientation_tpu"]


@pytest.mark.parametrize("module", ["reference.py", "costs.py", "synth.py", "weights.py",
                                    "layer.py", "harness.py"])
def test_the_yardstick_imports_nothing_of_the_port(module):
    tree = ast.parse((HERE / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & (set(harness.FORBIDDEN) | {"pointcloud_orientation_tpu_torch"})
