"""The port's analyzer (``tpu_cc_manager_torch/analysis/``) held to the
reference's.

The 78 cases of tests/test_analysis.py run on both packages
(``tests/torch_mirror.py``): the port's twin takes the analyzer copies'
path rewrite too, so its fixtures' relpaths (``tpu_cc_manager_torch/
snippet.py``), its snippets' imports and its CLI calls (``python -m
tpu_cc_manager_torch.analysis``) name the port, and every assertion must
hold on each side. The committed-baseline cases hold the port's tree to
the port's own baseline (``analysis/baseline.json``, empty).

Beyond the cases:

- the whole-tree parity test: every copied module of both packages, with
  its ``# ccaudit: allow-…`` pragmas disarmed, scanned by its own
  package's analyzer, gives the same findings with the package name
  masked (and there are some);
- the fact cache under one root serves each analyzer only its own
  pickles: a port scan never unpickles a reference ``ModuleAudit``
  (that would import the reference).
"""

import pickle
import re

import pytest

import test_analysis  # noqa: E402
import tpu_cc_manager.analysis as janalysis  # noqa: E402
import tpu_cc_manager_torch.analysis as tanalysis  # noqa: E402
from test_torch_copies import COPIES, OWNED, ROOT  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402
from tpu_cc_manager_torch.analysis import core as tcore  # noqa: E402
from tpu_cc_manager_torch.analysis import rules as trules  # noqa: E402

#: the cases the port must see differently, each with its reason
EDITS = (
    ("scripts/ and bench.py belong to the reference: the port's default "
     "surface is its own package alone (an owned unit of "
     "analysis/core.py), so --files drops them",
     '''    assert on_default_surface("scripts/bench_trend.py")
    assert on_default_surface("bench.py")
''', '''    assert not on_default_surface("scripts/bench_trend.py")
    assert not on_default_surface("bench.py")
'''),
)

MODS = (test_analysis, port_twin("test_analysis", EDITS, paths=True))


@pytest.mark.parametrize("name,params", [
    pytest.param(*p.values, id=p.id) for p in cases(test_analysis)])
def test_analysis_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, "ccaudit")


# ------------------------------------------------- whole-tree parity

#: a pragma's marker; disarmed, the comment stays and so do the lines
_PRAGMA = re.compile(r"#(\s*)ccaudit:(\s*)allow-")
_PKG = re.compile(r"\btpu_cc_manager(?:_torch)?\b")


def _masked(text: str) -> str:
    return _PKG.sub("<pkg>", text)


def _view(findings, exact):
    """Findings with the package name masked: (rule, file, line,
    message) in a module that differs only by the rewrite, (rule, text)
    in one with owned units (its lines may move)."""
    out = []
    for f in findings:
        module = f.file.split("/", 1)[1]
        if module in exact:
            out.append((f.rule, _masked(f.file), f.line,
                        _masked(f.message)))
        else:
            out.append((f.rule, _masked(f.text)))
    return sorted(out, key=repr)


def test_copies_with_pragmas_disarmed_find_the_same_on_both_packages(
        tmp_path):
    for pkg in ("tpu_cc_manager", "tpu_cc_manager_torch"):
        for module in COPIES:
            dst = tmp_path / pkg / module
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(_PRAGMA.sub(r"#\1disarmed:\2allow-",
                                       (ROOT / pkg / module).read_text()))
    ref = janalysis.analyze_paths(str(tmp_path), ["tpu_cc_manager"],
                                  with_manifests=False)
    port = tanalysis.analyze_paths(str(tmp_path), ["tpu_cc_manager_torch"],
                                   with_manifests=False)
    exact = set(COPIES) - set(OWNED)
    assert _view(port, exact) == _view(ref, exact)
    assert len(ref) > 0
    # the disarmed pragmas are what the live scans stay clean by; the
    # path-keyed rules fire on both packages' copies
    assert {f.rule for f in port} >= {"swallow", "race-lockset",
                                      "direct-node-write", "region-bypass"}


# ------------------------------------------------------- fact cache


def test_the_fact_cache_serves_each_analyzer_its_own_facts(tmp_path,
                                                           monkeypatch):
    """One root, one module both analyzers scan under the same relpath
    and source: the cache keys embed each analyzer's own source digest,
    so the two never share an entry, and the port's warm scan loads only
    its own ``ModuleAudit``s."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "import threading\nL = threading.Lock()\n"
        "def f():\n    L.acquire()\n")
    for analysis in (janalysis, tanalysis, tanalysis):
        found = analysis.analyze_paths(str(tmp_path), ["pkg"], cache=True)
        assert [f.rule for f in found] == ["raw-acquire"]
    entries = sorted(p.name for p in (tmp_path / tcore.CACHE_DIR_NAME)
                     .iterdir())
    assert len(entries) == 2
    assert {e.rsplit("-", 1)[1] for e in entries} == {
        janalysis.core.analyzer_version_hash() + ".pkl",
        tcore.analyzer_version_hash() + ".pkl"}
    loaded = []
    real = pickle.load

    def load(f):
        value = real(f)
        loaded.append(type(value))
        return value

    monkeypatch.setattr(tcore.pickle, "load", load)
    tanalysis.analyze_paths(str(tmp_path), ["pkg"], cache=True)
    assert loaded == [trules.ModuleAudit]
