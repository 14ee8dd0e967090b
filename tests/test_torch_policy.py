"""The port's policy controller (``policy.py``) held to the reference's.

The 71 cases of tests/test_policy.py (77 with the parametrized spec
cases) run on both packages (``tests/torch_mirror.py``): every assertion
holds on each side, and the labels, annotations, taints and pods of
every node, the Events posted and every value the write batcher
published must be equal on the two sides. Every case that reaches the
planner (a policy scan's ``plan.analyze_pools`` over the controller's
``PoolScanScratch``, or a rollout's preflight) runs on a one-shard
planner and on an 8-shard one (``TPU_CC_PLANNER_MESH``); the port plans
on the CPU (``TPU_CC_TORCH_DEVICE=cpu``), where its kernels run their
plain versions.

No mirrored case binds a fixed port. ``PolicyController`` defaults to
port 8091, and tests/test_policy.py may run on another worker at the
same time; so every controller a mirrored case builds, on both sides,
binds an ephemeral port (``port=0``) unless the case passes one. The
class each side's test module and package see is wrapped for the case's
duration; neither the reference's test file nor either package changes.
The other default ports the two files could reach (the fleet
controller's 8090, the agent's health port 8089, the webhook's 8443)
are never bound: the cases build no fleet controller and no admission
server, and their agents (``SimNode``) serve health on port 0.

One named edit adapts the reference's text: the full-stack case runs the
port's agents (the port twin of tests/test_multinode.py's ``SimNode``).

Beyond the cases: ``analyze_pools`` over one ``PoolScanScratch`` per
package, scan after scan over a seeded fleet of 2 000 nodes in 8 pools
(churn, nodes leaving and joining, every node moved to another pool,
pools dropped), must give the reference's counts exactly, at 1 and at 8
shards.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_policy  # noqa: E402
import tpu_cc_manager.plan as jplan  # noqa: E402
import tpu_cc_manager.policy as jpolicy  # noqa: E402
import tpu_cc_manager_torch.policy as tpolicy  # noqa: E402
import tpu_cc_manager_torch.rollout as trollout  # noqa: E402
from torch_mirror import (  # noqa: E402
    both, cases, planner_calls, port_twin, sharded,
)
from test_torch_plan import _fleet, _pools  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

port_twin("test_multinode")  # the port's agents, as test_multinode__port
MODS = (test_policy, port_twin("test_policy", edits=[
    ("the port's agents in the full-stack case",
     "from test_multinode import SimNode, _wait",
     "from test_multinode__port import SimNode, _wait"),
]))

#: the cases that never reach the planner (spec parsing, the fake's
#: custom resources, the record fences, a scan that fails before its
#: pool scan); every other case does (a scan's ``analyze_pools``, a
#: rollout's preflight) and runs at 1 and at 8 shards. The test holds
#: this true.
OFF_PLANNER = frozenset({
    "test_busy_port_raises_oserror_not_hang",
    "test_cli_once_fails_when_crd_missing",
    "test_custom_resource_watch_over_the_wire",
    "test_custom_resources_over_the_wire",
    "test_fake_custom_resource_404s",
    "test_fake_custom_resource_generation_semantics",
    "test_fake_custom_resource_watch", "test_interval_validation",
    "test_list_cluster_custom_sorted_and_scoped",
    "test_parse_policy_spec_defaults", "test_parse_policy_spec_rejects",
    "test_persist_fences_foreign_owner",
    "test_persist_fences_foreign_unfinished_record_id",
    "test_scan_failure_degrades_healthz", "test_window_open_semantics",
    "test_window_spec_validation",
})
PLANNER = frozenset(p.values[0] for p in cases(test_policy)) - OFF_PLANNER


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: repeated runs of this file, several at once on a busy CPU,
#: found no case that differs; a case joins only with the evidence of
#: ``tests/torch_mirror_selfcheck.py`` (which runs every entry here).
RACY = {}


def _ephemeral(cls):
    """``cls`` binding port 0 unless the caller passes a port."""

    class Ephemeral(cls):
        def __init__(self, *a, port=0, **kw):
            super().__init__(*a, port=port, **kw)

    Ephemeral.__name__ = Ephemeral.__qualname__ = cls.__name__
    return Ephemeral


def prepare(mp, shards=1):
    """A mirrored case's surroundings: the port plans on the CPU at
    ``shards`` shards, and no controller binds a fixed port."""
    mp.setenv(tplan.DEVICE_ENV, "cpu")
    mp.setenv(tplan.MESH_ENV, str(shards))
    for module in (*MODS, jpolicy, tpolicy):
        mp.setattr(module, "PolicyController",
                   _ephemeral(module.PolicyController))


@pytest.mark.parametrize("name,params,shards",
                         sharded(cases(test_policy), PLANNER))
def test_policy_case_on_both_packages(name, params, shards, request,
                                      tmp_path, monkeypatch):
    prepare(monkeypatch, shards)
    with planner_calls(monkeypatch, [(tpolicy, "analyze_pools"),
                                     (trollout, "analyze_fleet")]) as calls:
        both(MODS, name, params, request, tmp_path, VERSIONS, RACY)
    assert bool(calls) == (name in PLANNER), (
        f"{name} {'reaches' if calls else 'does not reach'} the port's "
        "planner: OFF_PLANNER must say so")


# ------------------------------------------- the pool scan itself


def _churn(nodes, rng, frac):
    """``nodes`` with ``frac`` of them relabelled to another observed
    state (each a new object, as a fresh LIST returns)."""
    out = list(nodes)
    for i in rng.choice(len(out), int(len(out) * frac), replace=False):
        node = copy.deepcopy(out[i])
        node["metadata"]["labels"][L.CC_MODE_STATE_LABEL] = str(
            rng.choice(["on", "off", "devtools", "failed"]))
        out[i] = node
    return out


def _scans(n, seed):
    """The pool lists of successive policy scans over a seeded fleet of
    ``n`` nodes in 8 pools: the first, one after 1 % of the nodes
    change, one after nodes leave and join, one with every node moved
    to the next pool and the targets rotated, one with two pools gone
    (their nodes unclaimed), and a repeat."""
    rng = np.random.default_rng(seed)
    nodes = _fleet(n, seed)
    first = _pools(nodes, 8)
    churned = _churn(nodes, rng, 0.01)
    joined = churned[n // 50:] + _fleet(n // 50 + n, seed + 1)[n:]
    modes = ["on", "off", "devtools", "ici"]
    moved = [(f"pool-{p}", modes[(p + 1) % 4], joined[(p + 1) % 8::8])
             for p in range(8)]
    return [first, _pools(churned, 8), _pools(joined, 8), moved,
            moved[:6], moved[:6]]


@pytest.mark.parametrize("shards", [1, 8])
def test_pool_scans_over_a_scratch_match_the_reference(shards, monkeypatch):
    """The policy controller's ``analyze_pools`` over one
    ``PoolScanScratch`` per package, scan after scan: the counts of every
    pool must be equal. The reference runs on its one-device mesh (its
    sharded delta scatter drops rows, ROADMAP Queue 3); the port at
    ``shards`` shards."""
    monkeypatch.setenv(tplan.MESH_ENV, "1")
    jscratch = jplan.PoolScanScratch()
    monkeypatch.setenv(tplan.MESH_ENV, str(shards))
    tscratch = tplan.PoolScanScratch(device="cpu")
    for i, pools in enumerate(_scans(2000, seed=8)):
        monkeypatch.setenv(tplan.MESH_ENV, "1")
        want = jplan.analyze_pools(pools, scratch=jscratch)
        monkeypatch.setenv(tplan.MESH_ENV, str(shards))
        got = tplan.analyze_pools(pools, scratch=tscratch)
        assert got == want, f"scan {i}: port and reference differ " \
                            f"({VERSIONS})"
    stats = tscratch.session.stats
    assert stats["incr_ticks"] >= 3 and stats["delta_rows"] > 0, stats
