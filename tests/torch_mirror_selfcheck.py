"""The reference's racy mirror cases, run against themselves.

A case in the ``RACY`` table of ``tests/test_torch_{agent,multinode,
slice,rollout,policy}.py`` is compared on a part of what it leaves
behind, on the claim
that the reference differs from itself run to run past that part. This
runs each such case on the reference ``MIRROR_RUNS`` times (10 by
default) and prints one JSON line per case: the runs, how many left a
snapshot equal to the first run's, and the first differing field of each
run that did not ("the reference" there is the first run, "the port" the
later one). It fails if the compared part itself differs between runs.
Most of these races show only with the CPU busy: run several copies at
once. Not part of the tier-1 suite (the file name does not match
``test_*.py``); run it by name, without ``-n``, so that its lines print:

    JAX_PLATFORMS=cpu MIRROR_RUNS=10 python -m pytest \
        tests/torch_mirror_selfcheck.py -q -s -p no:cacheprovider
"""

import collections
import json
import os

import pytest

pytest.importorskip("torch")

import test_torch_agent  # noqa: E402
import test_torch_multinode  # noqa: E402
import test_torch_policy  # noqa: E402
import test_torch_rollout  # noqa: E402
import test_torch_slice  # noqa: E402
from torch_mirror import REF, _first_difference, run_case  # noqa: E402

RUNS = int(os.environ.get("MIRROR_RUNS", "10"))
CASES = [(mod, name) for mod in (test_torch_agent, test_torch_multinode,
                                 test_torch_slice, test_torch_rollout,
                                 test_torch_policy)
         for name in sorted(mod.RACY)]


@pytest.mark.parametrize("mod,name", CASES, ids=[n for _, n in CASES])
def test_reference_against_itself(mod, name, request, tmp_path,
                                  monkeypatch):
    if hasattr(mod, "prepare"):
        mod.prepare(monkeypatch)
    view = getattr(mod, "_view", lambda _name, _side, snap: snap)
    part = mod.RACY[name][0]
    snaps = []
    for i in range(RUNS):
        run_tmp = tmp_path / f"run{i}"
        run_tmp.mkdir()
        snaps.append(view(name, REF, run_case(REF, mod.MODS[0], name, {},
                                              request, run_tmp)))
    diffs = [_first_difference(snaps[0], s) for s in snaps[1:]]
    print(json.dumps({
        "case": name, "runs": RUNS,
        "equal_to_first": 1 + sum(d is None for d in diffs),
        "first_differences": collections.Counter(
            d for d in diffs if d is not None)}))
    for i, snap in enumerate(snaps[1:], 1):
        d = _first_difference(part(snaps[0]), part(snap))
        assert d is None, f"run {i}: the compared part differs: {d}"
