"""The PyTorch port stands alone and never hides its device.

- No module of ``tpu_cc_manager_torch``, and not ``chip_smoke.py``,
  imports ``jax``, the JAX package or ``__graft_entry__`` — checked in a
  fresh interpreter (this one has JAX loaded by conftest) and in the
  sources, function-level imports included.
- With no CUDA device and no request for the CPU, the entry points
  raise instead of planning on the CPU.
- The CLI's live API path (``--kubeconfig``) is the reference's.
- ``chip_smoke.py`` exits non-zero, printing no result, without a card
  or without the repository around it.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.fleet import FleetController  # noqa: E402
from tpu_cc_manager_torch.graft_entry import (  # noqa: E402
    dryrun_multichip, entry,
)
from tpu_cc_manager_torch.k8s.fake import FakeKube  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_cc_manager_torch"
FORBIDDEN = ("jax", "jaxlib", "tpu_cc_manager", "__graft_entry__")

# One fresh interpreter, with no card visible, makes every check that
# needs one: the import check, the CLI without a card and chip_smoke.py
# without a card.
_CHILD = r"""
import contextlib, importlib, io, json, pkgutil, runpy, sys
import tpu_cc_manager_torch
mods = [m.name for m in pkgutil.walk_packages(
    tpu_cc_manager_torch.__path__, "tpu_cc_manager_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpu_cc_manager",
                                    "__graft_entry__"))
cli_out, cli_err = io.StringIO(), ""
sys.argv = ["tpu_cc_manager_torch.plan", "--from-file", sys.argv[1]]
try:
    with contextlib.redirect_stdout(cli_out):
        runpy.run_module("tpu_cc_manager_torch.plan", run_name="__main__")
except BaseException as e:
    cli_err = f"{type(e).__name__}: {e}"
smoke_out = io.StringIO()
with contextlib.redirect_stdout(smoke_out):
    smoke_rc = chip_smoke.main()
print(json.dumps({"modules": mods, "bad": bad, "cli_out": cli_out.getvalue(),
                  "cli_err": cli_err, "smoke_rc": smoke_rc,
                  "smoke_out": smoke_out.getvalue()}))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != tplan.DEVICE_ENV}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "nodes.json"
    path.write_text(json.dumps({"items": []}))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(path)],
                          cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_importing_the_port_loads_no_jax_and_no_reference_module(child):
    assert child["bad"] == []
    for mod in ("plan", "graft_entry", "labels", "modes", "watch",
                "kernels._build", "kernels.fleet_tick",
                "kernels.delta_scatter", "kernels.probe", "engine",
                "flipexec", "trace", "flightrec", "attest", "identity",
                "config", "__main__", "device.base", "device.cudadev",
                "device.statefile", "device.native", "device.gate",
                "device.holders", "device.fake", "k8s.client", "k8s.aio",
                "k8s.aio_bridge", "k8s.objects", "k8s.fake",
                "k8s.apiserver", "obs", "tsring", "watchdog", "profiler",
                "evidence", "leader", "fleet", "kernels.mesh_combine",
                "k8s.batch", "drain", "slice_coord", "doctor", "agent",
                "webhook", "rollout", "policy", "fleetobs", "shard",
                "federation", "analysis", "analysis.__main__",
                "analysis.core", "analysis.rules", "analysis.jitflow",
                "analysis.launchflow", "analysis.manifests",
                "analysis.slo"):
        assert f"tpu_cc_manager_torch.{mod}" in child["modules"]


#: modules of the port that an import names but that arrive with a later
#: slice, each with the slice that brings it; none today
PENDING: dict = {}


def _module_file(name):
    """The port's file for module ``name``, or None."""
    parts = name.split(".")[1:]
    if not parts:
        return PKG / "__init__.py"
    rel = pathlib.Path(*parts)
    for cand in (PKG / rel.with_suffix(".py"), PKG / rel / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _top_level_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _port_imports():
    """(source, module) for every import of a port module, lazy ones
    included; ``from pkg import name`` names a module when no top-level
    name of ``pkg`` is called so."""
    sources = [p for p in PKG.rglob("*.py")
               if "_build" not in p.relative_to(PKG).parts]
    sources.append(ROOT / "chip_smoke.py")
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
                base = _module_file(node.module)
                if base is not None:
                    defined = _top_level_names(base)
                    mods += [f"{node.module}.{a.name}" for a in node.names
                             if a.name not in defined]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] == "tpu_cc_manager_torch":
                    yield str(path.relative_to(ROOT)), mod


def test_every_port_module_an_import_names_exists_or_waits_for_its_slice():
    seen = set()
    for source, mod in _port_imports():
        seen.add(mod)
        assert _module_file(mod) is not None or mod in PENDING, (
            f"{source} imports {mod}, which the port does not have")
    # the list stays short and true: each pending module is still named
    assert set(PENDING) <= seen, sorted(set(PENDING) - seen)
    assert not [m for m in PENDING if _module_file(m) is not None]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
     if "_build" not in p.relative_to(PKG).parts]
    + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _no_cuda(monkeypatch):
    monkeypatch.delenv(tplan.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_and_without_a_cpu_request(
        monkeypatch):
    _no_cuda(monkeypatch)
    nodes = [{"metadata": {"name": "a", "labels": {}}}]
    with pytest.raises(RuntimeError, match=tplan.DEVICE_ENV):
        tplan.analyze_fleet(nodes)
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.analyze_fleet([])
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.analyze_pools([("p", "on", nodes)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.analyze_encoding(tplan.FleetEncoding())
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.TickSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.PoolScanScratch()
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.warmup(max_nodes=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetController(FakeKube())
    # asking for the CPU is the only way onto it
    assert tplan.analyze_fleet(nodes, device="cpu")["nodes"] == 1


def test_cli_without_cuda_fails_instead_of_planning_on_cpu(child):
    assert child["cli_err"].startswith("RuntimeError")
    assert tplan.DEVICE_ENV in child["cli_err"]
    assert child["cli_out"] == ""


@pytest.mark.parametrize("argv", [
    ["--kubeconfig", "/nonexistent"],
    ["--kubeconfig", "/nonexistent", "--from-file", "NODES"],
    [],
])
def test_kubeconfig_exits_nonzero_naming_the_later_slice(argv, tmp_path,
                                                         monkeypatch, capsys):
    """The live API path is ported now: ``--kubeconfig`` reaches the
    port's client and fails as the reference's does on a missing file
    (and on no kubeconfig at all), while ``--from-file`` still wins
    when both are given."""
    from tpu_cc_manager import plan as jplan

    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "missing-kubeconfig"))
    nodes = tmp_path / "nodes.json"
    nodes.write_text(json.dumps({"items": []}))
    argv = [str(nodes) if a == "NODES" else a for a in argv]
    outcomes = []
    for main in (jplan.main, tplan.main):
        try:
            outcomes.append(("rc", main(argv)))
        except Exception as e:  # noqa: BLE001 - compared across packages
            outcomes.append(("raised", type(e).__name__))
        outcomes.append(("out", capsys.readouterr().out))
    assert outcomes[:2] == outcomes[2:], outcomes
    if "--from-file" in argv:
        assert outcomes[0] == ("rc", 0)
    else:
        assert outcomes[0][0] == "raised" and outcomes[1] == ("out", "")


def test_chip_smoke_fails_without_a_card(child):
    assert child["smoke_rc"] != 0
    assert '"ok": true' not in child["smoke_out"]


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
