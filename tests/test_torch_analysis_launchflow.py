"""The port's kernel-launch pass (``analysis/launchflow.py``).

For each of its three families (``host-sync-in-hot-path``,
``unserialized-dispatch``, ``donation-violation``): a fixture that fires,
one that stays clean and one with a pragma, over a fixture kernel module
under ``tpu_cc_manager_torch/kernels/`` and a caller beside it, as
tests/test_analysis_jitflow.py does for jitted programs. Then the live
port: the launcher inventory pinned, every launch site outside
``kernels/`` under ``_DISPATCH_LOCK`` or a pragma, the three families
silent, and a scratch copy of the tree whose ``_eval_fn.run`` dispatches
without the lock: error-severity ``unserialized-dispatch`` findings,
which the ``--files`` slice of ``plan.py`` reports exactly as the full
run does.
"""

import ast
import shutil

import pytest

from tpu_cc_manager_torch import kernels
from tpu_cc_manager_torch.analysis import (
    callgraph,
    core,
    launchflow,
    rules,
    threads,
)
from tpu_cc_manager_torch.analysis.jitflow import (
    DISPATCH_RULE,
    DONATION_RULE,
    SYNC_RULE,
)

KERNEL = (
    "from tpu_cc_manager_torch.kernels import LAUNCHES, _build\n"
    "def _launch(x):\n"
    "    lib = _build.library()\n"
    "    lib.tcc_k(x.data_ptr())\n"
    "def tick(block):\n"
    "    _launch(block)\n"
    "    LAUNCHES['tick'] += 1\n"
    "    return {'n': block}\n"
    "def scatter(block, idx) -> None:\n"
    "    _launch(block)\n"
    "    LAUNCHES['scatter'] += 1\n"
    "def tick_reference(block):\n"
    "    return {'n': block}\n"
    "def probe_add_one(x):\n"
    "    _launch(x)\n"
    "    return x\n"
    "def width(block):\n"
    "    return block.shape[1]\n"
)

HEADER = (
    "import threading\n"
    "import numpy as np\n"
    "import torch\n"
    "from tpu_cc_manager_torch.kernels.k import (\n"
    "    probe_add_one, scatter, tick)\n"
    "_DISPATCH_LOCK = threading.Lock()\n"
)
#: the first line after HEADER
L0 = HEADER.count("\n") + 1


def _run(src, relpath="tpu_cc_manager_torch/planx.py"):
    return core.analyze_modules([
        core.Module("tpu_cc_manager_torch/kernels/k.py", KERNEL),
        core.Module(relpath, HEADER + src)])


def _hits(src, rule, **kw):
    return [f for f in _run(src, **kw) if f.rule == rule]


def _survey(modules):
    audits = [rules.audit_module(m) for m in modules]
    graph = callgraph.build(audits)
    return launchflow.survey(audits, graph,
                             threads.infer_roots(audits, graph))


def test_fixture_inventory_finds_the_launchers_from_the_code():
    inv, _ = _survey([core.Module("tpu_cc_manager_torch/kernels/k.py",
                                  KERNEL)])
    assert [(x.name, x.kernels, x.in_place, x.block_param, x.dispatch)
            for x in inv] == [
        ("tick", ("tick",), False, None, True),
        ("scatter", ("scatter",), True, "block", True),
        ("probe_add_one", (), False, None, False),
    ]


# ---------------------------------------------- host-sync-in-hot-path


def test_host_sync_item_on_launcher_output_in_hot_path_flagged():
    src = (
        "def scan_once(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        out = tick(block)\n"
        "    return out['n'].item()\n"
    )
    hits = _hits(src, SYNC_RULE)
    assert [h.line for h in hits] == [L0 + 3]
    assert hits[0].severity == "warning"
    assert "`.item()`" in hits[0].message


@pytest.mark.parametrize("sync", [
    "int(out['n'])", "out['n'].tolist()", "np.asarray(out['n'])",
    "out['n'].cpu()", "out['n'].to('cpu')", "torch.cuda.synchronize()",
    "torch.cuda.current_stream().synchronize()",
])
def test_host_sync_shapes_in_hot_path_flagged(sync):
    src = (
        "def scan_once(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        out = tick(block)\n"
        f"    return {sync}\n"
    )
    assert [h.line for h in _hits(src, SYNC_RULE)] == [L0 + 3]


def test_host_sync_iterating_a_launcher_output_flagged():
    src = (
        "def _scan(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        masks = tick(block)['n']\n"
        "    for m in masks:\n"
        "        pass\n"
    )
    assert [h.line for h in _hits(src, SYNC_RULE)] == [L0 + 3]


def test_host_sync_cpu_numpy_is_the_sanctioned_fetch():
    src = (
        "def _to_host(out):\n"
        "    return {k: v.cpu().numpy() for k, v in out.items()}\n"
        "def scan_once(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        out = tick(block)\n"
        "        host = out['n'].cpu().numpy()\n"
        "        also = out['n'].to('cpu').numpy()\n"
        "        fetched = _to_host(out)\n"
        "    return float(host), also.tolist(), int(fetched['n'][0])\n"
    )
    assert _hits(src, SYNC_RULE) == []


def test_host_sync_host_numpy_tolist_does_not_fire():
    # provenance, not name matching: host arrays were never on the card
    src = (
        "def scan_once(block, hit, moved):\n"
        "    with _DISPATCH_LOCK:\n"
        "        out = tick(block)\n"
        "    out = np.nonzero(hit)[0]\n"
        "    return moved.tolist(), out.tolist(), int(hit[0])\n"
    )
    assert _hits(src, SYNC_RULE) == []


def test_host_sync_silent_off_the_hot_path_and_under_simlab():
    src = (
        "def helper(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        out = tick(block)\n"
        "    return out['n'].item()\n"
        "def scan_once(block):\n"
        "    return probe_add_one(block).item()\n"
    )
    assert [h.line for h in _hits(src, SYNC_RULE)] == [L0 + 5]
    assert _hits(src, SYNC_RULE,
                 relpath="tpu_cc_manager_torch/simlab/lab.py") == []


def test_host_sync_pragma_alias_suppresses():
    src = (
        "def scan_once(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        out = tick(block)\n"
        "    return out['n'].item()"
        "  # ccaudit: allow-host-sync(one scalar, measured cheap)\n"
    )
    assert _hits(src, SYNC_RULE) == []


# --------------------------------------------- unserialized-dispatch


def test_dispatch_without_lock_flagged_as_error():
    src = (
        "def go(block):\n"
        "    return tick(block)\n"
    )
    hits = _hits(src, DISPATCH_RULE)
    assert [h.line for h in hits] == [L0 + 1]
    assert hits[0].severity == "error"
    assert "_DISPATCH_LOCK" in hits[0].message
    assert "`tick`" in hits[0].message


@pytest.mark.parametrize("call", [
    "k.scatter(block, 0)", "kernels.k.tick(block)",
])
def test_dispatch_through_a_module_attribute_flagged(call):
    src = (
        "from tpu_cc_manager_torch import kernels\n"
        "from tpu_cc_manager_torch.kernels import k\n"
        "def go(block):\n"
        f"    return {call}\n"
    )
    assert [h.line for h in _hits(src, DISPATCH_RULE)] == [L0 + 3]


def test_dispatch_through_a_re_export_flagged():
    # ``planx`` imported ``tick``; a third module calls it through planx
    findings = core.analyze_modules([
        core.Module("tpu_cc_manager_torch/kernels/k.py", KERNEL),
        core.Module("tpu_cc_manager_torch/planx.py", HEADER),
        core.Module("tpu_cc_manager_torch/user.py",
                    "from tpu_cc_manager_torch import planx\n"
                    "def go(block):\n"
                    "    return planx.tick(block)\n")])
    assert [(f.file, f.line, f.rule) for f in findings] == [
        ("tpu_cc_manager_torch/user.py", 3, DISPATCH_RULE)]


def test_dispatch_under_lexical_lock_clean():
    src = (
        "def go(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        return tick(block)\n"
    )
    assert _hits(src, DISPATCH_RULE) == []


def test_dispatch_held_by_the_caller_through_the_locked_suffix_clean():
    src = (
        "def tick_all(block):\n"
        "    with _DISPATCH_LOCK:\n"
        "        return _tick_locked(block)\n"
        "def _tick_locked(block):\n"
        "    return tick(block)\n"
    )
    assert _hits(src, DISPATCH_RULE) == []
    # one caller without the lock and the intersection is empty
    src += (
        "def stray(block):\n"
        "    return _tick_locked(block)\n"
    )
    assert [h.line for h in _hits(src, DISPATCH_RULE)] == [L0 + 4]


def test_dispatch_pragma_suppresses():
    src = (
        "def go(block):\n"
        "    return tick(block)"
        "  # ccaudit: allow-unserialized-dispatch(single-threaded tool)\n"
    )
    assert _hits(src, DISPATCH_RULE) == []


def test_the_readiness_probe_and_non_launchers_need_no_lock():
    src = (
        "from tpu_cc_manager_torch.kernels.k import tick_reference, width\n"
        "def ready(x):\n"
        "    return probe_add_one(x), tick_reference(x), width(x)\n"
    )
    assert _run(src) == []


def test_calls_inside_kernels_are_not_dispatch_sites():
    src = KERNEL + (
        "def tick_twice(block):\n"
        "    tick(block)\n"
        "    return tick(block)\n"
    )
    assert core.analyze_modules([
        core.Module("tpu_cc_manager_torch/kernels/k.py", src)]) == []


# ------------------------------------------------- donation-violation


def test_block_read_after_in_place_launch_flagged():
    src = (
        "def apply(block, idx):\n"
        "    with _DISPATCH_LOCK:\n"
        "        scatter(block, idx)\n"
        "    return block.sum()\n"
    )
    hits = _hits(src, DONATION_RULE)
    assert [h.line for h in hits] == [L0 + 3]
    assert hits[0].severity == "warning"
    assert f"line {L0 + 2}" in hits[0].message


def test_block_passed_by_keyword_read_after_launch_flagged():
    src = (
        "def apply(b, idx):\n"
        "    with _DISPATCH_LOCK:\n"
        "        scatter(idx=idx, block=b)\n"
        "    return b\n"
    )
    assert [h.line for h in _hits(src, DONATION_RULE)] == [L0 + 3]


def test_block_rebound_before_read_or_not_in_place_clean():
    src = (
        "def apply(block, idx, fresh):\n"
        "    with _DISPATCH_LOCK:\n"
        "        scatter(block, idx)\n"
        "        block = fresh()\n"
        "        out = tick(idx)\n"
        "    return block, idx, out\n"
    )
    assert _hits(src, DONATION_RULE) == []


def test_donation_pragma_alias_suppresses():
    src = (
        "def apply(block, idx):\n"
        "    with _DISPATCH_LOCK:\n"
        "        scatter(block, idx)\n"
        "    return block.sum()"
        "  # ccaudit: allow-donation(reads the rewritten rows on purpose)\n"
    )
    assert _hits(src, DONATION_RULE) == []


# --------------------------------------------------------- the live port


@pytest.fixture(scope="module")
def live():
    return launchflow.survey_paths()


#: public functions of kernels/ that launch nothing, each with why
NOT_LAUNCHERS = {
    "reset_launches": "zeroes the launch counters",
    "check_pool_slots": "refuses a pool bucket before any launch",
    "unpack_aggregates": "slices a launch's outputs into views",
    "counts_len": "the size of K1's summed head",
    "nvcc_path": "the builder's", "source_digest": "the builder's",
    "library_path": "the builder's", "library": "the builder's",
    "check": "the builder's",
    "takes": "says whether K6 takes a key, on the host",
    "limbs": "packs numbers into limbs on the host",
    "key_table": "builds K6's key table on the host",
}


def test_live_inventory_names_every_launcher_of_kernels(live):
    inv, _ = live
    assert [(x.name, x.kernels, x.in_place, x.dispatch) for x in inv] == [
        ("delta_scatter", ("delta_scatter",), True, True),
        ("delta_scatter_shards", ("delta_scatter",), True, True),
        ("fleet_tick_block", ("fleet_tick",), False, True),
        ("fleet_tick_partial", ("fleet_tick_partial",), False, True),
        ("fleet_plan_shards", ("fleet_plan",), False, True),
        ("fleet_plan", ("fleet_plan",), False, True),
        ("mesh_combine", ("mesh_combine",), False, True),
        ("mesh_sum", ("mesh_combine",), False, True),
        ("probe_add_one", ("probe_add_one",), False, False),
        ("rsa_verify", ("rsa_verify",), False, True),
    ]
    # every launch counter belongs to a launcher in the inventory
    assert {k for x in inv for k in x.kernels} == set(kernels.LAUNCHES)
    # and every other public function of kernels/ says why it is none
    named = {x.name for x in inv}
    root = core.repo_root()
    for rel in core.iter_python_files(root, ["tpu_cc_manager_torch/kernels"]):
        tree = ast.parse(open(f"{root}/{rel}").read())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and \
                    not node.name.startswith("_") and \
                    not node.name.endswith("_reference"):
                assert node.name in named or node.name in NOT_LAUNCHERS, (
                    f"{rel}: {node.name} is neither a launcher nor named")


def test_live_launch_sites_hold_the_lock_or_a_pragma(live):
    _, sites = live
    dispatch = [(s.file.rsplit("/", 1)[1], s.launcher, s.status)
                for s in sites if s.rule == DISPATCH_RULE]
    assert sorted(dispatch) == sorted([
        ("graft_entry.py", "fleet_plan_shards", "locked"),
        ("graft_entry.py", "mesh_sum", "locked"),
        ("graft_entry.py", "fleet_plan", "locked"),
        # plan.fleet_tick: the public tensor-level tick (its pragma's
        # reason)
        ("plan.py", "fleet_tick_block", "pragma"),
        # _mesh_tick, through _eval_fn.run's lock
        ("plan.py", "fleet_tick_partial", "locked"),
        ("plan.py", "mesh_combine", "locked"),
        ("plan.py", "fleet_tick_block", "locked"),
        ("plan.py", "delta_scatter_shards", "locked"),
        # the group plan's RS256 batch
        ("rs256.py", "rsa_verify", "locked"),
    ])
    assert [s for s in sites if s.status == "finding"] == []


def test_live_tree_passes_the_three_families_clean():
    findings = core.analyze_paths(with_manifests=False)
    assert [f for f in findings
            if f.rule in launchflow.LAUNCHFLOW_RULES] == []


# ------------------------------------ a copy of the tree without the lock


def unlock_eval_fn(source: str) -> str:
    """``plan.py`` with the ``with _DISPATCH_LOCK:`` of ``_eval_fn``'s
    ``run`` turned into ``if True:`` (every line stays where it was)."""
    tree = ast.parse(source)
    (line,) = [
        w.lineno for f in ast.walk(tree)
        if isinstance(f, ast.FunctionDef) and f.name == "_eval_fn"
        for w in ast.walk(f) if isinstance(w, ast.With)
        and ast.unparse(w.items[0].context_expr) == "_DISPATCH_LOCK"]
    lines = source.splitlines(keepends=True)
    assert lines[line - 1].strip() == "with _DISPATCH_LOCK:"
    lines[line - 1] = lines[line - 1].replace("with _DISPATCH_LOCK:",
                                              "if True:")
    return "".join(lines)


@pytest.fixture(scope="module")
def unlocked(tmp_path_factory):
    root = tmp_path_factory.mktemp("unlocked")
    shutil.copytree(f"{core.repo_root()}/tpu_cc_manager_torch",
                    root / "tpu_cc_manager_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    plan = root / "tpu_cc_manager_torch" / "plan.py"
    plan.write_text(unlock_eval_fn(plan.read_text()))
    return str(root), core.analyze_paths(str(root), with_manifests=False)


def test_dispatch_without_the_lock_in_eval_fn_fires_as_error(unlocked):
    root, findings = unlocked
    hits = [f for f in findings if f.rule == DISPATCH_RULE]
    lines = open(f"{root}/tpu_cc_manager_torch/plan.py").read().splitlines()
    # run's own K1 launch, and _mesh_tick's partials and combine, whose
    # one caller no longer holds the lock
    assert sorted(name for f in hits for name in (
        "fleet_tick_block", "fleet_tick_partial", "mesh_combine")
        if f"{name}(" in lines[f.line - 1]) == [
        "fleet_tick_block", "fleet_tick_partial", "mesh_combine"]
    assert len(hits) == 3
    assert all(f.file == "tpu_cc_manager_torch/plan.py"
               and f.severity == "error" for f in hits)
    assert {f.rule for f in findings} == {DISPATCH_RULE}


def test_files_slice_of_plan_equals_the_full_runs(unlocked):
    root, findings = unlocked
    target = "tpu_cc_manager_torch/plan.py"
    sub = core.analyze_paths(root, [target], subset=True)
    assert sub == [f for f in findings if f.file == target]
    assert sub
