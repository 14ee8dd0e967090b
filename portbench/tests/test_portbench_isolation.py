"""What the benchmark loads: nothing of the JAX package, JAX itself, the
repository's old benchmark or its scripts; and the plain reference
nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_cc_manager", "__graft_entry__",
             "bench", "chip_smoke", "scripts"}


def imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def sources(sub=""):
    return [p for p in glob.glob(f"{ROOT}/portbench/{sub}**/*.py",
                                 recursive=True) if "/tests/" not in p]


def test_no_source_imports_a_forbidden_module():
    bad = [(p, m) for p in sources() for m in imported_names(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    bad = [(p, m) for p in sources("reference/") for m in imported_names(p)
           if m.split(".")[0] in FORBIDDEN | {"tpu_cc_manager_torch", "torch"}
           or (m.startswith("portbench") and not m.startswith(
               "portbench.reference"))]
    assert not bad
    code = ("import sys, json; import portbench.reference.check, "
            "portbench.reference.history, portbench.reference.model; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout))
    assert not loaded & (FORBIDDEN | {"tpu_cc_manager_torch", "torch"})


def test_a_whole_run_loads_nothing_forbidden(tmp_path):
    """The import closure of a run: one cell end to end on the CPU in a
    fresh interpreter, then every top-level module it holds."""
    code = f"""
import json, os, sys, time
sys.path[:0] = [{ROOT!r}, {os.path.dirname(__file__)!r}]
os.environ["TPU_CC_TORCH_DEVICE"] = "cpu"
import tinyroot
root = tinyroot.make({str(tmp_path)!r})
from portbench.harness import run_cell, forbidden_modules
r = run_cell(root, "k8s5k.preflight", 2**31 + 7, 2.0, False,
             require_cuda=False)
# the held rolling cell too: its import closure is the fleet controller's
run_cell(root, "k8s5k.rolling", 2**31 + 7, 2.0, False, require_cuda=False)
print(json.dumps({{"correct": r["correct"],
                   "modules": sorted({{m.split('.')[0] for m in sys.modules}}),
                   "forbidden": forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not set(got["modules"]) & FORBIDDEN
    assert got["forbidden"] == []
    assert "tpu_cc_manager_torch" in got["modules"]


def test_the_command_alone_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    prints no result and exits non-zero."""
    import shutil

    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "k8s5k.preflight",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "tpu_cc_manager_torch" in out.stderr
