"""ccaudit core: findings, pragma parsing, module scanning, orchestration.

The per-module AST walk lives in ``rules.py``; the cross-module passes
(lock-order cycles, metric-name registry) consume the per-module results
here so a single ``analyze_paths()`` call yields one flat finding list.
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import pickle
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: ``# ccaudit: allow-<rule>(<reason>)`` — the reason is mandatory; a
#: suppression with no recorded why is just a finding wearing a disguise.
PRAGMA_RE = re.compile(r"#\s*ccaudit:\s*allow-([a-z][a-z-]*)\s*\(\s*([^)]+?)\s*\)")

#: What the analyzer scans by default, relative to the repo root — the
#: same surface ``make lint`` compiles. Tests are deliberately excluded:
#: fixtures legitimately hard-code wire-protocol strings to assert them.
DEFAULT_TARGETS = ("tpu_cc_manager_torch",)

_EXCLUDE_DIRS = {"__pycache__", "native", "tests", ".git"}


@dataclass(frozen=True, order=True)
class Finding:
    file: str  #: repo-relative posix path
    line: int
    rule: str
    message: str
    text: str  #: stripped source line — the baseline's drift detector
    #: SARIF level for a NEW finding: "error" (the historical default —
    #: every pre-v4 rule gates hard) or "warning" (the v4 asyncflow
    #: advisory families; ``loop-self-deadlock`` stays "error": a
    #: ``.result()`` on the loop thread is a guaranteed deadlock, not a
    #: judgement call). The baseline gate ignores severity — any new
    #: finding fails the ratchet either way.
    severity: str = "error"

    def key(self) -> Tuple[str, str, int, str]:
        return (self.rule, self.file, self.line, self.text)

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "text": self.text,
        }


class Module:
    """One parsed source file plus its pragma map and line cache."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=relpath)
        self._lines = source.splitlines()
        self.pragmas = _parse_pragmas(source)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self._lines):
            return self._lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        """A pragma suppresses its rule on its own line or the line below
        (i.e. write the pragma on the flagged line or just above it)."""
        for ln in (lineno, lineno - 1):
            if rule in self.pragmas.get(ln, ()):
                return True
        return False


def _parse_pragmas(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            for m in PRAGMA_RE.finditer(tok.string):
                out.setdefault(tok.start[0], set()).add(m.group(1))
    except tokenize.TokenError:
        pass  # unparseable tail; ast.parse already vetted the file
    return out


def collect_imports(tree: ast.Module) -> Dict[str, str]:
    """alias -> real dotted prefix for one module: ``sp`` →
    ``subprocess``, ``sleep`` → ``time.sleep``, ``L`` →
    ``tpu_cc_manager_torch.labels``; ``import http.client`` binds the local
    name ``http``. The ONE import fold every rule family shares."""
    imports: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    imports[top] = top
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                imports[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )
    return imports


def dotted(expr: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def resolve_dotted(expr: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Dotted path with import aliases folded in (``sp`` → ``subprocess``,
    ``L`` → ``tpu_cc_manager_torch.labels``) — the ONE resolution fold every
    rule family shares, so they can never disagree on what a name means."""
    path = dotted(expr)
    if path is None:
        return None
    head, _, rest = path.partition(".")
    real = imports.get(head)
    if real:
        return f"{real}.{rest}" if rest else real
    return path


def module_dotted(relpath: str) -> str:
    """Repo-relative path → importable dotted module path
    (``tpu_cc_manager_torch/device/fake.py`` → ``tpu_cc_manager_torch.device.fake``;
    a package ``__init__.py`` maps to the package itself). The call
    graph keys every function by this, so two ``fake.py`` files in
    different packages can never collide."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


def repo_root() -> str:
    """The repo root is two levels above this package (…/tpu_cc_manager_torch/
    analysis/core.py); resolving from ``__file__`` keeps the CLI working
    from any cwd."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def iter_python_files(root: str, targets: Sequence[str]) -> List[str]:
    """Repo-relative posix paths of every .py file under ``targets``.

    A target that matches no Python files (typo, renamed surface) is a
    loud error — a gate that quietly stops scanning is worse than none.
    """
    out: List[str] = []
    for target in targets:
        found = []
        full = os.path.join(root, target)
        if os.path.isfile(full):
            if full.endswith(".py"):
                found.append(target.replace(os.sep, "/"))
        else:
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in _EXCLUDE_DIRS
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fn), root
                        )
                        found.append(rel.replace(os.sep, "/"))
        if not found:
            raise FileNotFoundError(
                f"ccaudit scan target {target!r} matched no Python files "
                f"under {root}"
            )
        out.extend(found)
    return sorted(set(out))


def on_default_surface(relpath: str) -> bool:
    """Whether a repo-relative path belongs to the default scan surface.
    The ``--files`` mode uses this to drop changed files the merge gate
    never scans (tests hard-code wire-protocol strings to assert them;
    flagging a fixture the full run would never see is pure noise)."""
    rel = relpath.replace(os.sep, "/")
    if any(part in _EXCLUDE_DIRS for part in rel.split("/")[:-1]):
        return False
    return any(
        rel == target or rel.startswith(target + "/")
        for target in DEFAULT_TARGETS
    )


#: where the opt-in per-module fact cache lives, relative to the repo
#: root (gitignored; ``--cache`` / ``make lint-fast`` turn it on)
CACHE_DIR_NAME = ".ccaudit_cache"


def analyzer_version_hash() -> str:
    """Digest of the analyzer's own sources. Cache keys embed it, so
    editing ANY rule module invalidates every cached fact — the cache
    can never serve facts a different analyzer computed."""
    h = hashlib.sha256()
    pkg = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(pkg)):
        if fn.endswith(".py"):
            h.update(fn.encode("utf-8"))
            with open(os.path.join(pkg, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def load_audit_cached(root: str, relpath: str, cache_dir: str,
                      version: str):
    """Per-module parse + audit through the fact cache.

    Key = sha256(relpath + source) + analyzer version: an unchanged
    module re-loads its pickled ModuleAudit (AST, accesses, calls,
    locks, per-module findings — everything the whole-program passes
    consume) instead of re-walking; any source or analyzer change
    misses and re-parses. Corrupt or unreadable entries fall back to a
    fresh parse — the cache can slow a scan down, never change it.
    Returns None for unparseable modules (same contract as
    ``load_module``)."""
    from tpu_cc_manager_torch.analysis import rules

    with open(os.path.join(root, relpath), "r", encoding="utf-8") as f:
        src = f.read()
    digest = hashlib.sha256(
        (relpath + "\0" + src).encode("utf-8")
    ).hexdigest()[:32]
    path = os.path.join(cache_dir, f"{digest}-{version}.pkl")
    try:
        with open(path, "rb") as f:
            audit = pickle.load(f)
        if getattr(audit, "module", None) is not None \
                and audit.module.relpath == relpath:
            return audit
    except Exception:
        # ccaudit: allow-swallow(cache miss / corrupt / stale-format entry: the contract is fall back to a fresh parse — a cache can slow a scan down, never break it)
        pass
    try:
        mod = Module(relpath, src)
    except SyntaxError:
        return None
    audit = rules.audit_module(mod)
    try:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(audit, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: concurrent scans never see halves
    except Exception:
        # ccaudit: allow-swallow(cache write failure — read-only checkout, full disk: the scan already has the fresh audit in hand and proceeds uncached)
        pass
    return audit


def load_module(root: str, relpath: str) -> Optional[Module]:
    with open(os.path.join(root, relpath), "r", encoding="utf-8") as f:
        src = f.read()
    try:
        return Module(relpath, src)
    except SyntaxError:
        # compileall (the other half of `make lint`) owns syntax errors;
        # double-reporting them here would just be noise
        return None


# --------------------------------------------------------------------- runs


def analyze_modules(
    modules: Sequence[Module], call_depth: Optional[int] = None,
) -> List[Finding]:
    """Run every rule over already-parsed modules (the seam the fixture
    tests use: build Modules from inline snippets, skip the filesystem).

    v4 pipeline: parse → per-module rules → whole-program call graph →
    thread roots → transitive lock-order/blocking + lockset race pass →
    asyncflow (await-atomicity, loop-affinity, task-lifecycle,
    async-exception) → findings (the baseline gate is the caller's job).
    """
    findings, _ = _analyze_modules(modules, call_depth)
    return findings


def _analyze_modules(
    modules: Sequence[Module], call_depth: Optional[int] = None,
    audits: Optional[list] = None,
) -> Tuple[List[Finding], list]:
    """analyze_modules plus the per-module audits — analyze_paths
    feeds the audits' metric-declaration registry to the slo
    cross-check (analysis/slo.py). ``audits`` short-circuits the
    per-module stage with already-computed (possibly cache-loaded)
    ModuleAudits, aligned 1:1 with ``modules`` — the whole-program
    passes below always run fresh over the full fact set, so a cache
    hit can never change what a scan reports."""
    from tpu_cc_manager_torch.analysis import (
        asyncflow,
        callgraph,
        dataflow,
        jitflow,
        launchflow,
        lockgraph,
        lockset,
        resourceflow,
        rules,
        threads,
    )

    findings: List[Finding] = []
    if audits is None:
        audits = [rules.audit_module(mod) for mod in modules]
    for result in audits:
        findings.extend(result.findings)
    depth = callgraph.DEPTH_LIMIT if call_depth is None else call_depth
    graph = callgraph.build(audits, depth)
    sink_summaries = dataflow.collect_sink_summaries(audits, graph)
    for mod, audit in zip(modules, audits):
        findings.extend(
            dataflow.protocol_findings(mod, audit, graph, sink_summaries)
        )
    findings.extend(lockgraph.order_findings(audits, graph))
    findings.extend(callgraph.blocking_findings(audits, graph))
    roots = threads.infer_roots(audits, graph)
    async_lock_quals = frozenset(
        q for a in audits for q in a.async_lock_quals
    )
    findings.extend(
        lockset.race_findings(audits, graph, roots, async_lock_quals)
    )
    findings.extend(asyncflow.async_findings(audits, graph, roots))
    findings.extend(jitflow.jitflow_findings(audits, graph, roots))
    findings.extend(launchflow.launchflow_findings(audits, graph, roots))
    findings.extend(resourceflow.resource_findings(audits, graph))
    findings.extend(rules.metric_findings(audits))
    findings.extend(rules.liveness_findings(audits))
    findings.extend(rules.direct_write_findings(modules))
    findings.extend(rules.planner_bypass_findings(modules))
    findings.extend(rules.shard_bypass_findings(modules))
    findings.extend(rules.region_bypass_findings(modules))
    findings.extend(rules.blocking_in_async_findings(modules))
    findings.extend(rules.poll_in_watch_path_findings(modules))
    return sorted(findings), audits


def analyze_paths(
    root: Optional[str] = None,
    targets: Sequence[str] = DEFAULT_TARGETS,
    with_manifests: Optional[bool] = None,
    call_depth: Optional[int] = None,
    subset: bool = False,
    cache: bool = False,
) -> List[Finding]:
    """Full repo scan: the AST rules over ``targets`` plus — when scanning
    the default surface (or when ``with_manifests`` forces it) — the
    code↔manifest cross-check over the deploy/scenario trees.

    ``subset=True`` (the CLI's ``--files`` mode) marks ``targets`` as a
    changed-files slice — but the ANALYSIS still runs over the full
    default surface, and only the REPORT is restricted to the slice.
    Whole-program facts (caller-held locksets, thread roots,
    loop-confinement, settle closures) computed over a slice would
    diverge from the merge gate's: a write is unguarded or a function
    mixed-context only relative to every caller, and most callers live
    outside any given diff. Filtering the report instead guarantees a
    subset run flags exactly the full run's findings for those files.
    Only the manifest/slo cross-checks are skipped — their findings
    land on manifest files a Python slice can never contain.

    ``cache=True`` (the CLI's ``--cache``) routes the per-module parse
    stage through the content-hash fact cache under
    ``<root>/.ccaudit_cache/`` — only changed modules re-parse, while
    the whole-program passes still run fresh over every module's
    facts, so a cached scan reports exactly what an uncached one
    would."""
    root = root or repo_root()
    report_only: Optional[Set[str]] = None
    if subset:
        report_only = set(iter_python_files(root, targets))
        targets = DEFAULT_TARGETS
        with_manifests = False
    if with_manifests is None:
        with_manifests = tuple(targets) == DEFAULT_TARGETS
    modules = []
    audits_in: Optional[list] = None
    if cache:
        cache_dir = os.path.join(root, CACHE_DIR_NAME)
        os.makedirs(cache_dir, exist_ok=True)
        version = analyzer_version_hash()
        audits_in = []
        for rel in iter_python_files(root, targets):
            audit = load_audit_cached(root, rel, cache_dir, version)
            if audit is not None:
                modules.append(audit.module)
                audits_in.append(audit)
    else:
        for rel in iter_python_files(root, targets):
            mod = load_module(root, rel)
            if mod is not None:
                modules.append(mod)
    findings, audits = _analyze_modules(modules, call_depth, audits_in)
    if with_manifests:
        from tpu_cc_manager_torch.analysis import manifests, slo

        findings.extend(manifests.manifest_findings(root))
        # the slo cross-check rides the manifest surface: schema
        # (manifest-drift) + metric liveness against the scan's
        # declaration registry (the metric-name rule, extended)
        declared = {
            name for a in audits for name in a.metric_decls
        }
        findings.extend(slo.slo_findings(root, declared))
    if report_only is not None:
        findings = [f for f in findings if f.file in report_only]
    return sorted(findings)


def analyze_source(
    source: str, relpath: str = "snippet.py",
    call_depth: Optional[int] = None,
) -> List[Finding]:
    """Analyze one in-memory module — the unit-test entry point."""
    return analyze_modules([Module(relpath, source)], call_depth)
