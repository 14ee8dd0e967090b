"""The port's copies of the JAX-free modules, held to the reference unit by
unit: each is the reference's source rewritten as
:func:`reference_as_port` says. A unit (:func:`units`) the port changed or
added is owned: ``OWNED`` names it with its reason ("new:" where the
reference lacks it). Every other unit equals the reference's byte for
byte, an owned unit still differs from it, and the units keep the
reference's order. Mirrored tests hold what owned units do to the
reference: for rollout.py test_torch_rollout.py,
test_torch_attested_preflight.py and test_torch_preflight_spans.py; for
identity.py and attest.py test_torch_identity.py, test_torch_attest.py and
test_torch_attested_preflight.py; for trace.py
test_torch_preflight_spans.py; for device/base.py and config.py
test_torch_cudadev.py; for analysis/ test_torch_analysis.py,
test_torch_analysis_v3.py and test_torch_analysis_launchflow.py.
"""

import ast
import difflib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"^(\s*)(from|import)\s+tpu_cc_manager\b")
_PATH = re.compile(r"\btpu_cc_manager(?=[./])")

#: the directory whose copies take the path rewrite too: the analyzer keys
#: its rules on its own package's paths and dotted names in literals
PATH_REWRITTEN = "analysis/"

COPIES = (
    "device/base.py", "device/statefile.py", "device/native.py",
    "device/gate.py", "device/holders.py", "device/fake.py",
    "device/__init__.py", "trace.py", "flightrec.py", "k8s/client.py",
    "k8s/aio.py", "k8s/aio_bridge.py", "flipexec.py", "attest.py",
    "identity.py", "engine.py", "config.py", "modes.py",
    "k8s/objects.py", "k8s/fake.py", "k8s/apiserver.py", "k8s/__init__.py",
    "obs.py", "tsring.py", "watch.py", "watchdog.py", "profiler.py",
    "evidence.py", "leader.py", "fleet.py", "labels.py", "k8s/batch.py",
    "drain.py", "slice_coord.py", "doctor.py", "agent.py", "webhook.py",
    "rollout.py", "policy.py", "fleetobs.py", "shard.py",
    "federation.py", "simlab/scenario.py", "simlab/report.py",
    "simlab/pump.py", "simlab/replica.py", "simlab/faults.py",
    "simlab/invariants.py", "simlab/runner.py", "simlab/federation.py",
    "simlab/propgen.py", "simlab/__init__.py",
    # the analyzer, in import order
    "analysis/core.py", "analysis/baseline.py", "analysis/rules.py",
    "analysis/callgraph.py", "analysis/threads.py", "analysis/lockset.py",
    "analysis/lockgraph.py", "analysis/dataflow.py",
    "analysis/asyncflow.py", "analysis/jitflow.py",
    "analysis/resourceflow.py", "analysis/manifests.py", "analysis/slo.py",
    "analysis/sarif.py", "analysis/__init__.py", "analysis/__main__.py",
)

#: module -> {unit: why the port changed it, or added it ("new: ...")}
OWNED = {
    "device/base.py": {"_default_backend": "cuda replaces jax as default",
                       "get_backend": "its docstring names the cuda default"},
    "config.py": {"build_parser": "probe-devices --backend: cuda for jax"},
    "analysis/core.py": {"DEFAULT_TARGETS": "the port's package alone",
                         "_analyze_modules": "launchflow runs by jitflow"},
    "analysis/rules.py": {"_METRIC_IGNORE": "the port's name is no metric"},
    "trace.py": {"Span": "a slot for the span's monotonic start, t0",
                 "Span.__init__": "t0's initial value",
                 "Tracer.span": "keeps t0: spans on the device trace's clock"},
    "rollout.py": {"Rollout.__init__": "judges' times and counts, parses",
                   "Rollout.run": "the spans; the RS256 pre-pass and batch",
                   "Rollout._evidence_suspects": "parse reused, judges timed",
                   "Rollout._count_judge": "new: counts one judgement"},
    "identity.py": {
        "from contextvars import ContextVar": "new: for rs256_batch",
        "jwks_loads": "new: JWKS files read, on the group plan's span",
        "load_jwks": "counts each read",
        "rs256_batch": "new: the group plan's RS256 batch (kernel K6)",
        "_rsa_pkcs1_sha256_verify": "answers from the batch where it can",
        "_signed_parts": "new: one decode for every RS256 check",
        "verify_token": "decodes through _signed_parts"},
    "attest.py": {"_judge_cs_token": "decodes through identity._signed_parts"},
}


def rewrite_imports(text: str) -> str:
    """The reference source as the port imports it: ``tpu_cc_manager``
    becomes ``tpu_cc_manager_torch`` in import statements only."""
    out = []
    for line in text.splitlines(keepends=True):
        m = _IMPORT.match(line)
        if m:
            line = line[:m.end()] + "_torch" + line[m.end():]
        out.append(line)
    return "".join(out)


def rewrite_paths(text: str) -> str:
    """``text`` with every ``tpu_cc_manager`` followed by ``/`` or ``.``
    naming the port: paths and dotted names, in code and literals."""
    return _PATH.sub("tpu_cc_manager_torch", text)


def reference_as_port(module: str) -> str:
    """The reference's ``module`` rewritten as its copy's rule says."""
    text = rewrite_imports((ROOT / "tpu_cc_manager" / module).read_text())
    return rewrite_paths(text) if module.startswith(PATH_REWRITTEN) else text


def _start(node: ast.stmt, lines: list, floor: int) -> tuple:
    """Where ``node``'s unit starts: its first decorator, or the comments
    directly above it at its indent, not above index ``floor``; its name: a
    def's, class's or lone assignment target's, else its first line."""
    decorators = getattr(node, "decorator_list", [])
    first = min(n.lineno for n in [node, *decorators]) - 1
    while first > floor and lines[first - 1].startswith(
            " " * node.col_offset + "#"):
        first -= 1
    target = getattr(node, "targets", [getattr(node, "target", None)])
    lone = isinstance(node, (ast.Assign, ast.AnnAssign)) and len(target) == 1
    return first, getattr(node, "name", None) or (
        target[0].id if lone and isinstance(target[0], ast.Name)
        else lines[node.lineno - 1].strip())


def units(text: str) -> dict:
    """``text`` as {unit: source}, in order: the preamble, each top-level
    statement, and of a top-level class its header and non-method body,
    then each method (``Class.method``); a name met again takes `` #2``."""
    lines = text.splitlines(keepends=True)
    tree = ast.parse(text)
    doc = ast.get_docstring(tree, clean=False) is not None
    starts = [(0, "<preamble>")]  # (first line, name; None: the class's)
    floor = tree.body[0].end_lineno if doc else 0
    for node in tree.body[doc:]:
        starts.append(_start(node, lines, floor))
        inner = node.lineno
        for sub in node.body if isinstance(node, ast.ClassDef) else ():
            first, name = _start(sub, lines, inner)
            method = isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
            starts.append((first, f"{node.name}.{name}" if method else None))
            inner = sub.end_lineno
        floor = node.end_lineno
    out, seen = {}, {}
    starts.append((len(lines), ""))
    for (first, name), (end, _) in zip(starts, starts[1:]):
        if name is None:
            out[cls] += "".join(lines[first:end])
            continue
        seen[name] = seen.get(name, 0) + 1
        key = name if seen[name] == 1 else f"{name} #{seen[name]}"
        out[key] = "".join(lines[first:end])
        if "." not in name:  # a class's own name has no dot, a method's has
            cls = key
    return out


def drift(ref: str, port: str, owned: dict) -> list:
    """How ``port`` breaks the copy rule against ``ref`` and ``owned``."""
    want, got = units(ref), units(port)
    new, out = {u for u, why in owned.items() if why.startswith("new:")}, []
    for u in dict.fromkeys([*want, *got, *owned]):
        if u in new:
            if u in want or u not in got:
                out.append(f"{u}: owned as new, so in the port alone")
        elif u not in want or u not in got:
            out.append(f"{u}: " + ("missing from the port" if u in want else
                                   "in the port alone" if u in got else
                                   "owned, but in neither source"))
        elif u in owned and want[u] == got[u]:
            out.append(f"{u}: owned, but equal to the reference")
        elif u not in owned and want[u] != got[u]:
            out.append("".join(difflib.unified_diff(
                want[u].splitlines(True), got[u].splitlines(True),
                f"reference {u}", f"port {u}", n=1)))
    if [u for u in got if u in want] != [u for u in want if u in got]:
        out.append("the port's units are out of the reference's order")
    return out


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_its_reference(module):
    port = (ROOT / "tpu_cc_manager_torch" / module).read_text()
    found = drift(reference_as_port(module), port, OWNED.get(module, {}))
    assert not found, "\n".join([f"{module} drifted:"] + found)[:4000]
    assert set(OWNED) <= set(COPIES)


#: a synthetic module for the self-tests, in parts that end between units
PARTS = ('"""A module."""\nimport os\nX = 1\n\n\n',
         "# f's comment\n@staticmethod\ndef f():\n    return 'f'\n\n\n",
         "class C:\n    y = 2\n\n    def m(self):\n        return 'm'\n\n"
         "    z = 3\n\n\n", "def g():\n    return 'g'\n\n\n", "import os\n")
SAMPLE, R, H = "".join(PARTS), "".join(PARTS).replace, "def h():\n    1\n"

#: id -> (port, owned units, whether the check holds against SAMPLE)
CASES = {
    "function": (R("'f'", "'F'"), {}, False),
    "method": (R("'m'", "'M'"), {}, False),
    "assignment": (R("X = 1", "X = 2"), {}, False),
    "comment-above-a-def": (R("f's", "F's"), {}, False),
    "stale-entry": (SAMPLE, {"g": "why"}, False),
    "stale-new-entry": (SAMPLE, {"h": "new: why"}, False),
    "unlisted-new-function": (SAMPLE + H, {}, False),
    "swapped-units": ("".join(PARTS[i] for i in (0, 3, 2, 1, 4)), {}, False),
    "equal": (SAMPLE, {}, True),
    "owned-def-with-its-comment": (R("f's", "F's"), {"f": "why"}, True),
    "owned-method": (R("'m'", "'M'"), {"C.m": "why"}, True),
    "owned-class-body": (R("z = 3", "z = 4"), {"C": "why"}, True),
    "owned-new-function": (SAMPLE + H, {"h": "new: why"}, True),
}


def test_a_source_splits_into_units_that_keep_their_comments():
    got = units(SAMPLE)
    assert list(got) == ["<preamble>", "import os", "X", "f", "C", "C.m",
                         "g", "import os #2"]
    assert (got["f"], got["X"], got["C"]) == (
        PARTS[1], "X = 1\n\n\n", "class C:\n    y = 2\n\n    z = 3\n\n\n")


@pytest.mark.parametrize("port,owned,holds", CASES.values(), ids=CASES)
def test_the_unit_check(port, owned, holds):
    assert (drift(SAMPLE, port, owned) == []) == holds


def test_the_rewrite_touches_import_statements_only():
    src = ('"""see tpu_cc_manager.engine"""\n'
           "from tpu_cc_manager import device as devlayer\n"
           "    from tpu_cc_manager.device.base import DeviceError\n"
           "import tpu_cc_manager.trace\n"
           "x = 'python -m tpu_cc_manager'\n"
           "from tpu_cc_manager_torch import plan\n")
    assert rewrite_imports(src) == (
        '"""see tpu_cc_manager.engine"""\n'
        "from tpu_cc_manager_torch import device as devlayer\n"
        "    from tpu_cc_manager_torch.device.base import DeviceError\n"
        "import tpu_cc_manager_torch.trace\n"
        "x = 'python -m tpu_cc_manager'\n"
        "from tpu_cc_manager_torch import plan\n")


def test_the_path_rewrite_names_the_port_in_paths_and_dotted_names():
    src = ('''"""python -m tpu_cc_manager.analysis"""\n'''
           "from tpu_cc_manager import labels\n"
           'X = ("tpu_cc_manager/simlab/", "tpu_cc_manager.labels.")\n'
           'T = ("tpu_cc_manager", "tpu_cc_manager_torch/plan.py")\n')
    assert rewrite_paths(rewrite_imports(src)) == (
        '''"""python -m tpu_cc_manager_torch.analysis"""\n'''
        "from tpu_cc_manager_torch import labels\n"
        'X = ("tpu_cc_manager_torch/simlab/", '
        '"tpu_cc_manager_torch.labels.")\n'
        'T = ("tpu_cc_manager", "tpu_cc_manager_torch/plan.py")\n')
