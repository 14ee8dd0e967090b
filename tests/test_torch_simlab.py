"""The port's scenario lab (``simlab/``) held to the reference's.

The 20 cases of tests/test_simlab.py run on both packages
(``tests/torch_mirror.py``) on a one-shard planner, and the case whose
lab runs controllers (it reaches the planner) again on 8 planner shards;
the port plans on the CPU (``TPU_CC_TORCH_DEVICE=cpu``). Every assertion
holds on each side.

A case that runs a live lab (``SimLab`` or ``FederationLab``) is compared
on what its schedule fixes, per lab run, in order (``lab_view``):

- ``ok``;
- the converged node set: the nodes whose ``cc.mode.state`` is the
  scenario's converge mode, read from the lab's API server;
- every node's final labels there;
- each entry of the fault log, and the injector's counts (replicas
  crashed, restarted, upgraded; nodes evacuated);
- ``check_run``'s violation list, run on each side's own oracle.

Masked in a live case, and why: the fault log's
``at_s`` (the timeline's clock when the action ran) and ``trace_id`` (a
random id per desired write); the artifact's ``metrics`` (convergence
seconds, percentiles, lag and throttle samples, counts of reconciles,
retries and writes, all of which move with thread timing); and the
mirror's own snapshot beside the labs: the API server's annotations
and Events (evidence generations and the doctor's verdicts land as the
faults happened to meet the flips), the write batcher's per-key
history (a node's intermediate states under a fault depend on timing),
the shard managers' coverage and failover logs, and the SLO observers'
alerts (each moves with lease renewals and scrape timing). A case with
no live lab (the schema, the injector's stubs, the watch pump) is
compared on the whole snapshot.

A case that builds a ``FaultInjector`` and never cancels it (the
injector's own tests arm a 60 s timer) leaves its timer threads armed;
once both sides have run, the mirror cancels every injector the case
built, as a lab's teardown does, so that the wait for the case's
threads to end does not wait out the timers.
"""

import contextlib
import copy
import importlib
import types

import pytest

torch = pytest.importorskip("torch")

import test_simlab  # noqa: E402
from test_torch_shard import run_mirrored  # noqa: E402
from torch_mirror import at_shards, cases, mask, port_twin  # noqa: E402

MODS = (test_simlab, port_twin("test_simlab"))

#: the cases whose lab runs a fleet or policy controller and so reaches
#: the planner; they run at 8 planner shards too. The test holds this
#: true.
PLANNER = frozenset({"test_live_sharded_run_survives_shard_kill"})

#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` (``MIRROR_FILES=simlab``)
#: found no case of this file leaving a view that differs from itself
#: (PERF.md §6); a case joins only with that evidence.
RACY = {}

#: the fault log's keys a live case's comparison leaves out (see the
#: module docstring)
_FAULT_CLOCK_KEYS = frozenset({"at_s", "trace_id"})

_LABS = (("simlab.runner", "SimLab"), ("simlab.federation", "FederationLab"))


@contextlib.contextmanager
def labs_recorded(mp):
    """Record, on either package, ``(lab, artifact)`` for every lab run,
    in order, and every ``FaultInjector`` built."""
    runs = types.SimpleNamespace(labs=[], injectors=[])
    for pkg in ("tpu_cc_manager", "tpu_cc_manager_torch"):
        for module, name in _LABS:
            cls = getattr(importlib.import_module(f"{pkg}.{module}"), name)

            def run(self, _real=cls.run):
                artifact = _real(self)
                runs.labs.append((self, artifact))
                return artifact

            mp.setattr(cls, "run", run)
        injector = importlib.import_module(f"{pkg}.simlab.faults")
        init = injector.FaultInjector.__init__

        def record(self, *a, _init=init, **kw):
            _init(self, *a, **kw)
            runs.injectors.append(self)

        mp.setattr(injector.FaultInjector, "__init__", record)
    yield runs


def _stores(lab):
    if lab.server is not None:
        return [lab.server.store]
    return [cell.store for cell in lab.cells.values()]


def lab_view(side, lab, artifact):
    """What one lab run's schedule fixes (see the module docstring)."""
    state_key = side.module("labels").CC_MODE_STATE_LABEL
    labels = {}
    for store in _stores(lab):
        with store._lock:
            nodes = copy.deepcopy(store._nodes)
        for name, node in nodes.items():
            labels[name] = mask(dict(sorted(
                (node["metadata"].get("labels") or {}).items())))
    target = lab.scenario.converge.mode
    injector = lab.injector
    injected = None if injector is None else {
        "crashed": injector.crashed_total,
        "restarted": injector.restarted_total,
        "upgraded": injector.upgraded_total,
        "evacuated": sorted(injector.evacuated_nodes),
    }
    check_run = side.module("simlab.invariants").check_run
    return {
        "ok": artifact["ok"],
        "converged": sorted(n for n, lb in labels.items()
                            if lb.get(state_key) == target),
        "labels": dict(sorted(labels.items())),
        "faults": [mask({k: v for k, v in entry.items()
                         if k not in _FAULT_CLOCK_KEYS})
                   for entry in artifact["faults"]],
        "injected": injected,
        "violations": [v.to_dict() for v in check_run(lab, artifact)],
    }


@contextlib.contextmanager
def mirror_view(mp):
    """Yield a ``torch_mirror.both`` view: the lab runs a side has made
    since the view's last call on that side (each lab is shown once),
    or its whole snapshot when it made none."""
    with labs_recorded(mp) as runs:
        def view(_name, side, snapshot):
            for injector in runs.injectors:
                injector.cancel()
            mine = [(lab, art) for lab, art in runs.labs
                    if type(lab).__module__.split(".")[0] == side.pkg]
            runs.labs[:] = [run for run in runs.labs if run not in mine]
            if not mine:
                return snapshot
            return {"labs": [lab_view(side, lab, art)
                             for lab, art in mine]}

        yield view


def run_simlab_case(mods, planner, racy, name, params, shards, request,
                    tmp_path, monkeypatch):
    """One mirrored simlab case: ``run_mirrored`` over the lab view."""
    with mirror_view(monkeypatch) as view:
        run_mirrored(mods, planner, racy, name, params, shards, request,
                     tmp_path, monkeypatch, view=view)


def mirror_params(mod, planner):
    """Every case at one planner shard, the ``planner`` cases at 8 too."""
    return (at_shards(cases(mod), 1)
            + at_shards(cases(mod), 8, only=planner))


@pytest.mark.parametrize("name,params,shards",
                         mirror_params(test_simlab, PLANNER))
def test_simlab_case_on_both_packages(name, params, shards, request,
                                      tmp_path, monkeypatch):
    run_simlab_case(MODS, PLANNER, RACY, name, params, shards, request,
                    tmp_path, monkeypatch)


def test_every_case_is_mirrored():
    assert len(cases(test_simlab)) == 20
    assert PLANNER <= {p.values[0] for p in cases(test_simlab)}
