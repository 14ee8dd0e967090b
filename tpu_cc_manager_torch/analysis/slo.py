"""ccaudit SLO cross-check — ``deployments/slo.yaml`` vs the code.

Two failure classes the AST rules cannot see (ISSUE 9 satellite):

- **schema drift** (rule ``manifest-drift``, like the rest of the
  manifest surface): the committed slo.yaml must validate under
  :func:`fleetobs.validate_slo_doc` — a file the observer would refuse
  at runtime must not merge;
- **metric liveness** (rule ``metric-name`` — the
  one-declaration-per-metric-name rule extended to this file): every
  objective's ``metric:``/``total_metric:`` must reference a metric
  name the code actually declares (and therefore, by the reflective
  one-render rule, actually renders). An objective watching a metric
  nobody emits is an alert that can never fire — the worst kind of
  monitoring, the kind you believe in. Escape hatch:
  ``# ccaudit: allow-metric-name(reason)`` on (or just above) the
  referencing line, for objectives aimed at externally-scraped series.

Findings flow through the same baseline ratchet as every other rule.
The file is a loud contract: scanning the default surface with the
file missing fails, exactly like an empty manifest glob.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Set

from tpu_cc_manager_torch.analysis.core import PRAGMA_RE, Finding
from tpu_cc_manager_torch.fleetobs import SLO_RELPATH, validate_slo_doc

RULE_SCHEMA = "manifest-drift"
RULE_LIVENESS = "metric-name"


def _finding(
    rule: str,
    relpath: str,
    lines: Sequence[str],
    lineno: int,
    message: str,
) -> Optional[Finding]:
    text = lines[lineno - 1].strip() if 1 <= lineno <= len(lines) else ""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            for m in PRAGMA_RE.finditer(lines[ln - 1]):
                if m.group(1) == rule:
                    return None
    return Finding(
        file=relpath, line=lineno, rule=rule, message=message, text=text
    )


def _find_line(
    lines: Sequence[str], needle: str, start: int = 1
) -> Optional[int]:
    for i in range(start - 1, len(lines)):
        if needle in lines[i]:
            return i + 1
    return None


def _warn_no_yaml() -> None:
    # one shared notice with the manifest pass (same skip contract)
    from tpu_cc_manager_torch.analysis import manifests

    manifests._warn_no_yaml()


def slo_findings(
    root: str,
    declared_metrics: Set[str],
    relpath: str = SLO_RELPATH,
) -> List[Finding]:
    """Run the SLO cross-check over ``<root>/<relpath>``.
    ``declared_metrics`` is the union of every
    Counter/Gauge/Histogram/HistogramVec declaration name the AST pass
    collected — the liveness registry."""
    path = os.path.join(root, *relpath.split("/"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"slo cross-check target {relpath!r} missing under {root} "
            "(a gate that quietly stops scanning is worse than none)"
        )
    try:
        import yaml
    except ImportError:  # pragma: no cover - pyyaml is a dev/CI dep
        _warn_no_yaml()
        return []
    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    lines = raw.splitlines()
    findings: List[Finding] = []
    try:
        doc = yaml.safe_load(raw)
    except yaml.YAMLError as e:
        mark = getattr(e, "problem_mark", None)
        lineno = mark.line + 1 if mark is not None else 1
        detail = " ".join(str(e).split())
        f2 = _finding(RULE_SCHEMA, relpath, lines, lineno,
                      f"unparseable slo.yaml: {detail}")
        return [f2] if f2 is not None else []
    objectives, errors = validate_slo_doc(doc)
    for error in errors:
        # anchor on the objective name when the error carries one
        lineno = 1
        if "(" in error and ")" in error:
            name = error.split("(", 1)[1].split(")", 1)[0]
            lineno = _find_line(lines, f"name: {name}") or 1
        f2 = _finding(
            RULE_SCHEMA, relpath, lines, lineno,
            f"slo.yaml schema violation: {error} — the observer would "
            "refuse this file at runtime",
        )
        if f2 is not None:
            findings.append(f2)
    for obj in objectives:
        anchor = _find_line(lines, f"name: {obj.name}") or 1
        for ref in obj.metric_refs():
            if ref in declared_metrics:
                continue
            lineno = _find_line(lines, ref, anchor) or anchor
            f2 = _finding(
                RULE_LIVENESS, relpath, lines, lineno,
                f"objective {obj.name!r} references metric {ref!r}, "
                "which matches no Counter/Gauge/Histogram/HistogramVec "
                "declaration — an objective over a metric nobody "
                "renders can never fire; fix the name or pragma an "
                "externally-scraped series",
            )
            if f2 is not None:
                findings.append(f2)
    return sorted(set(findings))


if __name__ == "__main__":  # pragma: no cover - debugging helper
    from tpu_cc_manager_torch.analysis.core import (
        DEFAULT_TARGETS, iter_python_files, load_module, repo_root,
    )
    from tpu_cc_manager_torch.analysis.rules import audit_module

    r = repo_root()
    declared: Set[str] = set()
    for rel in iter_python_files(r, DEFAULT_TARGETS):
        mod = load_module(r, rel)
        if mod is not None:
            declared.update(audit_module(mod).metric_decls)
    for f3 in slo_findings(r, declared):
        print(f3.render())
    sys.exit(0)
