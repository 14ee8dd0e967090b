"""The port's rollout controller (``rollout.py``) held to the reference's.

The 44 cases of tests/test_rollout.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and the
labels, annotations, taints and pods of every node, the Events posted
and every value the write batcher published must be equal on the two
sides. Every case that reaches the planner (``Rollout.run``'s preflight,
``plan.analyze_fleet``) runs on a one-shard planner and on an 8-shard
one (``TPU_CC_PLANNER_MESH``); the port plans on the CPU
(``TPU_CC_TORCH_DEVICE=cpu``), where its kernels run their plain
versions.

Named edits adapt the reference's text to the port: the two full-stack
cases run the port's agents (the port twin of tests/test_multinode.py's
``SimNode``), and ``_statefile_backend`` builds the PCI twin of its accel
tree (``tests/torch_pci_tree.py``) and the port's sysfs backend
(``device/gpu.py``) over it. The evidence of those cases names each
side's own device, ``<tmp>/dev/accel0`` or ``<tmp>/dev/nvidia0``, which
differ by name only, so there a device's path, name and ``device_id``
are compared by index, and the statefile digest, a hash over the device
paths, is compared within each side (``torch_pci_tree.by_index``).

Beyond the cases: the preflight's ``analyze_fleet`` over seeded fleets
of up to 3 000 nodes must give the reference's report exactly, at 1 and
at 8 shards.
"""

import inspect

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_rollout  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
import tpu_cc_manager.plan as jplan  # noqa: E402
import tpu_cc_manager_torch.rollout as trollout  # noqa: E402
from torch_mirror import (  # noqa: E402
    both, cases, planner_calls, port_twin, sharded,
)
from test_torch_plan import _fleet  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

port_twin("test_multinode")  # the port's agents, as test_multinode__port
MODS = (test_rollout, port_twin("test_rollout", edits=[
    ("the port's agents in the full-stack cases",
     "from tests.test_multinode import SimNode, _wait",
     "from test_multinode__port import SimNode, _wait", 2),
    ("the port's sysfs backend over the PCI twin tree",
     "    from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend\n",
     "    from torch_pci_tree import make_pci_tree\n"
     "    from torch_pci_tree import twin_backend as SysfsTpuBackend\n"),
    ("the PCI twin in place of the accel tree", '''    sysfs = tmp_path / "sysfs"
    devd = sysfs / "accel0" / "device"
    devd.mkdir(parents=True)
    (devd / "vendor").write_text("0x1ae0\\n")
    (devd / "device").write_text("0x0063\\n")
    (tmp_path / "dev").mkdir()
    (tmp_path / "dev" / "accel0").write_text("")
''', '''    sysfs, _dev = make_pci_tree(tmp_path, n=1)
'''),
]))

#: the cases that never reach the planner (they fail before the
#: preflight, or test the plan and the record without running); every
#: other case does (``Rollout.run``'s preflight, dry runs and resumes
#: included) and runs at 1 and at 8 shards. The test holds this true.
OFF_PLANNER = frozenset({
    "test_delta_judge_racing_group_timeout_picks_one_outcome",
    "test_empty_selector_refused",
    "test_explicit_selector_resume_never_wanders_to_another_pool",
    "test_explicit_selector_with_no_record_refuses",
    "test_invalid_mode_rejected_before_any_patch",
    "test_plan_groups_slices_and_singletons",
    "test_report_surfaces_stopped_groups_as_handoff",
    "test_resume_refuses_future_record_version",
})
PLANNER = frozenset(p.values[0] for p in cases(test_rollout)) - OFF_PLANNER

#: the cases whose evidence comes from ``_statefile_backend``: each side's
#: own sysfs backend over its own tree
OWN_DEVICE = frozenset(
    name for name, fn in vars(test_rollout).items()
    if name.startswith("test_") and inspect.isfunction(fn)
    and "_statefile_backend(" in inspect.getsource(fn))


def _view(name, side, snapshot):
    return pci.by_index(snapshot) if name in OWN_DEVICE else snapshot


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: repeated runs of this file, several at once on a busy CPU,
#: found no case that differs; a case joins only with the evidence of
#: ``tests/torch_mirror_selfcheck.py`` (which runs every entry here).
RACY = {}


def prepare(mp, shards=1):
    """A mirrored case's surroundings: the port plans on the CPU at
    ``shards`` shards."""
    mp.setenv(tplan.DEVICE_ENV, "cpu")
    mp.setenv(tplan.MESH_ENV, str(shards))


@pytest.mark.parametrize("name,params,shards",
                         sharded(cases(test_rollout), PLANNER))
def test_rollout_case_on_both_packages(name, params, shards, request,
                                       tmp_path, monkeypatch):
    prepare(monkeypatch, shards)
    with planner_calls(monkeypatch, [(trollout, "analyze_fleet")]) as calls:
        both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
             view=_view)
    assert bool(calls) == (name in PLANNER), (
        f"{name} {'reaches' if calls else 'does not reach'} the port's "
        "planner: OFF_PLANNER must say so")


# ------------------------------------------------- the preflight itself


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("n", [100, 3000])
def test_preflight_analyze_fleet_matches_the_reference(n, shards,
                                                       monkeypatch):
    """The preflight's ``analyze_fleet`` over a seeded fleet, on each
    package at ``shards`` shards: the reports must be equal, name lists
    and counts alike."""
    monkeypatch.setenv(tplan.MESH_ENV, str(shards))
    nodes = _fleet(n, seed=n + shards)
    want = jplan.analyze_fleet(nodes)
    got = tplan.analyze_fleet(nodes, device="cpu")
    assert got == want, f"port and reference differ ({VERSIONS})"
    assert want["nodes"] == n and want["failed"] and want["needs_flip"]
