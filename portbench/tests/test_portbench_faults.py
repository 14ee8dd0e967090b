"""A run with the timed path broken underneath comes out not correct: one
run per fault a cell can have (a step that returns its state unchanged,
half of the fleet left out, deltas dropped or never scattered into the
resident block, an answer altered where it is produced), and
the control, the reference in the precision below the configuration's
put in the program's place. One chip, so no exchange between chips to
leave out. Each skips the look for a card and drives the rest of a run
on the CPU."""

import copy

import pytest

import tinyroot
from portbench.harness import run_cell

SEED = 2 ** 32 + 11


def stale_plan(objs):
    """Every scan's planner answer is the first one it gave."""
    mod = objs["fleet_module"]
    orig = mod.analyze_encoding
    first = {}

    def stuck(enc, session=None, **kw):
        if "r" not in first:
            first["r"] = orig(enc, session=session, **kw)
        return copy.deepcopy(first["r"])

    objs["restore"].append((mod, "analyze_encoding", orig))
    mod.analyze_encoding = stuck


def half_listed(objs):
    client = objs["client"]
    orig = client.list_nodes
    client.list_nodes = lambda selector=None: orig(selector)[::2]


def dropped_deltas(objs):
    """The controller drops every delta its informer hands it: only the
    syncing scans move the feature block."""
    objs["ctrl"]._on_watch_event = lambda etype, node: None


def scatter_writes_nothing(objs):
    """K2 leaves the resident block as it was. The answers come from the
    host's rows; the session's verify tick reads the block, so it runs
    every other tick here for a short window to hold some."""
    objs["ctrl"]._tick_session.full_every = 2
    plan = objs["plan"]
    orig = plan._scatter_fn
    objs["restore"].append((plan, "_scatter_fn", orig))
    plan._scatter_fn = lambda nb, kb, mesh: (
        lambda shards, idx, vals: None)


def altered_answer(objs):
    plan = objs["plan"]
    orig = plan._format_report

    def altered(*args, **kwargs):
        r = orig(*args, **kwargs)
        if r["needs_flip"]:
            r["needs_flip"] = r["needs_flip"][1:]
        return r

    objs["restore"].append((plan, "_format_report", orig))
    plan._format_report = altered


def stale_preflight(objs):
    mod = objs["rollout_module"]
    orig = mod.analyze_fleet
    first = {}

    def stuck(nodes, **kw):
        if "r" not in first:
            first["r"] = orig(nodes, **kw)
        return copy.deepcopy(first["r"])

    objs["restore"].append((mod, "analyze_fleet", orig))
    mod.analyze_fleet = stuck


def half_discovered(objs):
    cls = objs["Rollout"]
    orig = cls.discover
    objs["restore"].append((cls, "discover", orig))
    cls.discover = lambda self: orig(self)[::2]


ROLLING = [stale_plan, half_listed, dropped_deltas, scatter_writes_nothing,
           altered_answer]
PREFLIGHT = [stale_preflight, half_discovered, altered_answer]


@pytest.mark.parametrize("cell,fault", [
    *(("gke15k.rolling", f) for f in ROLLING),
    *(("gke15k.preflight", f) for f in PREFLIGHT),
    *(("k8s5k.preflight", f) for f in PREFLIGHT),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                            cpu_planner):
    # doctor verdicts republished every second, so the fleet moves under
    # the preflight as well as the rolling change
    root = tinyroot.make(str(tmp_path), mix_edits={
        "preflight": {"background": {"kubelet_period_s": 300,
                                     "doctor_period_s": 1}}})
    r = run_cell(root, cell, SEED, 3.0, False, require_cuda=False,
                 fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["k8s5k.rolling", "gke15k.preflight",
                                  "k8s5k.preflight"])
def test_the_control_is_not_correct(cell, tmp_path, cpu_planner,
                                    sync_repaired):
    root = tinyroot.make(str(tmp_path))
    sound = run_cell(root, cell, SEED, 2.0, False, require_cuda=False)
    assert sound["correct"], sound["notes"]
    r = run_cell(root, cell, SEED, 2.0, False, require_cuda=False,
                 control=True)
    assert not r["correct"]
    assert r["checks"]["plan_mismatch"]["value"] > 0
