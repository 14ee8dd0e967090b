"""The reference's racy mirror cases, run against themselves.

A case in the ``RACY`` table of ``tests/test_torch_{agent,multinode,
slice,rollout,policy,shard,federation,fleetobs,simlab,propgen,slo_sim,
device,evidence,attest,identity,engine_regressions,verify_independent,
native}.py``
is compared on a part of what it leaves behind (as the file's
``mirror_view`` shows it, where it has one), on the claim
that the reference differs from itself run to run past that part. This
runs each such case on the reference ``MIRROR_RUNS`` times (10 by
default) and prints one JSON line per case: the runs, how many left a
snapshot equal to the first run's, the first differing field of each
run that did not ("the reference" there is the first run, "the port" the
later one), and the runs that raised, by error. It fails if the compared
part itself differs between runs, or if a run raised.
Most of these races show only with the CPU busy: run several copies at
once. Not part of the tier-1 suite (the file name does not match
``test_*.py``); run it by name, without ``-n``, so that its lines print:

    JAX_PLATFORMS=cpu MIRROR_RUNS=10 python -m pytest \
        tests/torch_mirror_selfcheck.py -q -s -p no:cacheprovider

Beside the ``RACY`` cases it always runs
``test_shard.py::test_shard_restart_rejoins_as_standby_without_preemption``,
whose ``kill_host`` now and then raises "cannot join thread before it is
started" on the reference alone (ROADMAP Queue 3), to measure how often.
``MIRROR_FILES=shard,federation`` runs every case of the named mirror
files (those a file mirrors, where it names them), compared whole, with
the calls the file records (its ``CALLS``): the evidence that a file's
``RACY`` table may be empty.
"""

import collections
import contextlib
import json
import os

import pytest

pytest.importorskip("torch")

import test_torch_agent  # noqa: E402
import test_torch_attest  # noqa: E402
import test_torch_device  # noqa: E402
import test_torch_engine_regressions  # noqa: E402
import test_torch_evidence  # noqa: E402
import test_torch_federation  # noqa: E402
import test_torch_fleetobs  # noqa: E402
import test_torch_identity  # noqa: E402
import test_torch_multinode  # noqa: E402
import test_torch_native  # noqa: E402
import test_torch_policy  # noqa: E402
import test_torch_propgen  # noqa: E402
import test_torch_rollout  # noqa: E402
import test_torch_shard  # noqa: E402
import test_torch_simlab  # noqa: E402
import test_torch_slice  # noqa: E402
import test_torch_slo_sim  # noqa: E402
import test_torch_verify_independent  # noqa: E402
from torch_mirror import REF, _first_difference, cases, run_case  # noqa: E402

RUNS = int(os.environ.get("MIRROR_RUNS", "10"))
MODULES = {"agent": test_torch_agent, "multinode": test_torch_multinode,
           "slice": test_torch_slice, "rollout": test_torch_rollout,
           "policy": test_torch_policy, "shard": test_torch_shard,
           "federation": test_torch_federation,
           "fleetobs": test_torch_fleetobs, "simlab": test_torch_simlab,
           "propgen": test_torch_propgen, "slo_sim": test_torch_slo_sim,
           "device": test_torch_device, "evidence": test_torch_evidence,
           "attest": test_torch_attest, "identity": test_torch_identity,
           "engine_regressions": test_torch_engine_regressions,
           "verify_independent": test_torch_verify_independent,
           "native": test_torch_native}
#: the shard restart race (ROADMAP Queue 3), measured on every run
RESTART = (test_torch_shard,
           "test_shard_restart_rejoins_as_standby_without_preemption")
CASES = [(mod, name) for mod in MODULES.values() for name in sorted(mod.RACY)]
for key in filter(None, os.environ.get("MIRROR_FILES", "").split(",")):
    mod = MODULES[key]
    only = getattr(mod, "PYTHON_SIDE", None)
    CASES += [(mod, p.values[0]) for p in getattr(mod, "CASES", None)
              or cases(mod.MODS[0])
              if not p.values[1] and (only is None or p.values[0] in only)]
CASES = list(dict.fromkeys(CASES + [RESTART]))


@pytest.mark.parametrize("mod,name", CASES, ids=[n for _, n in CASES])
def test_reference_against_itself(mod, name, request, tmp_path,
                                  monkeypatch):
    if hasattr(mod, "prepare"):
        mod.prepare(monkeypatch)
    recorded = getattr(mod, "mirror_view", None)
    part = mod.RACY[name][0] if name in mod.RACY else (lambda snap: snap)
    snaps, raised = [], collections.Counter()
    with (recorded(monkeypatch) if recorded
          else contextlib.nullcontext(None)) as mirror:
        view = mirror or getattr(mod, "_view",
                                 lambda _name, _side, snap: snap)
        for i in range(RUNS):
            run_tmp = tmp_path / f"run{i}"
            run_tmp.mkdir()
            try:
                snaps.append(view(name, REF, run_case(
                    REF, mod.MODS[0], name, {}, request, run_tmp,
                    getattr(mod, "CALLS", None))))
            except Exception as e:  # counted, printed, and failed below
                raised[f"{type(e).__name__}: {str(e)[:200]}"] += 1
    diffs = [_first_difference(snaps[0], s) for s in snaps[1:]] if snaps \
        else []
    print(json.dumps({
        "case": name, "runs": RUNS, "raised": raised,
        "equal_to_first": int(bool(snaps)) + sum(d is None for d in diffs),
        "first_differences": collections.Counter(
            d for d in diffs if d is not None)}))
    for i, snap in enumerate(snaps[1:], 1):
        d = _first_difference(part(snaps[0]), part(snap))
        assert d is None, f"run {i}: the compared part differs: {d}"
    assert not raised, f"runs that raised: {dict(raised)}"
