"""ccaudit manifest cross-check — code↔manifest protocol drift.

The kustomize/manifest tree and the simlab scenario files carry their own
copies of the cluster-visible protocol: label/taint keys in tolerations,
nodeAffinity and webhook objectSelectors, the TPUCCPolicy CRD's ``mode``
enum, and the desired-mode strings scenario timelines patch onto nodes.
None of that YAML/JSON is visible to the AST rules, so a constant renamed
in ``labels.py`` (or a Mode member added to ``modes.py``) would leave the
deploy tree silently advertising a protocol the code no longer speaks —
a fleet-wide correctness bug no test executes.

This pass closes the loop, in both directions:

- **manifest → code**: every ``*.google.com/...``-shaped key anywhere in
  the manifest tree must equal a value exported by ``labels.py``, and
  every ``mode``/``initial_mode`` string value in a scenario or CRD must
  be a ``modes.VALID_MODES`` member;
- **code → manifest**: every TPUCCPolicy CRD ``mode`` enum must equal
  ``VALID_MODES`` *exactly* — so adding a Mode member fails CI until the
  CRD (and therefore the cluster's admission surface) learns it too.

Findings carry the matched line so they flow through the same baseline
ratchet as every AST rule; YAML lines can be pragma'd
(``# ccaudit: allow-manifest-drift(reason)``), JSON (no comments) is
baseline-only. The file set is deliberately a loud contract: a glob that
matches nothing fails, because a gate that quietly stops scanning is
worse than none (the same stance ``core.iter_python_files`` takes).
"""

from __future__ import annotations

import glob as _glob
import json
import os
import re
import sys
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from tpu_cc_manager_torch import labels as _labels
from tpu_cc_manager_torch.analysis.core import PRAGMA_RE, Finding
from tpu_cc_manager_torch.modes import VALID_MODES

RULE = "manifest-drift"

#: Scanned manifest surface, relative to the repo root.
MANIFEST_GLOBS = (
    "deployments/kustomize/*.yaml",
    "deployments/manifests/*.yaml",
    "scenarios/*.json",
)

#: ``<something>.google.com/<path>`` — requires at least one subdomain
#: label before ``google.com``, so the plain ``google.com/tpu`` extended
#: resource toleration doesn't match. Built to cover both the
#: tpu.google.com and cloud.google.com protocol families.
_KEY_RE = re.compile(
    r"[A-Za-z0-9-]+(?:\.[A-Za-z0-9-]+)*\.google\.com/[A-Za-z0-9._-]+"
)

#: JSON/YAML object keys whose string value is a desired mode.
#: ``rival_mode`` is the policy_conflict fault's second claim (ISSUE
#: 12) — a typo'd mode there would otherwise only fail at load time.
_MODE_FIELDS = ("mode", "initial_mode", "rival_mode")


def code_protocol_keys() -> Set[str]:
    """Every ``*.google.com/...`` key the code exports from labels.py —
    pulled from the live module so the check can never drift from the
    source of truth it is defending."""
    keys: Set[str] = set()

    def harvest(value: object) -> None:
        if isinstance(value, str):
            keys.update(_KEY_RE.findall(value))
        elif isinstance(value, (tuple, list, frozenset, set)):
            for v in value:
                harvest(v)
        elif isinstance(value, dict):
            for k, v in value.items():
                harvest(k)
                harvest(v)

    for name in dir(_labels):
        if name.startswith("_"):
            continue
        harvest(getattr(_labels, name))
    # the CRD/CR apiVersion composite is protocol too, derived from the
    # same constants
    keys.add(f"{_labels.POLICY_GROUP}/{_labels.POLICY_VERSION}")
    return keys


def _finding(
    relpath: str,
    lines: Sequence[str],
    lineno: int,
    message: str,
) -> Optional[Finding]:
    text = lines[lineno - 1].strip() if 1 <= lineno <= len(lines) else ""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            for m in PRAGMA_RE.finditer(lines[ln - 1]):
                if m.group(1) == RULE:
                    return None
    return Finding(
        file=relpath, line=lineno, rule=RULE, message=message, text=text
    )


def _find_line(
    lines: Sequence[str], needle: str, start: int = 1
) -> Optional[int]:
    """First line >= ``start`` containing ``needle``, 1-indexed."""
    for i in range(start - 1, len(lines)):
        if needle in lines[i]:
            return i + 1
    return None


def _scan_keys(
    relpath: str, lines: Sequence[str], known: Set[str]
) -> Iterable[Finding]:
    for i, line in enumerate(lines, start=1):
        for key in _KEY_RE.findall(line):
            if key in known:
                continue
            f = _finding(
                relpath, lines, i,
                f"protocol key {key!r} has no labels.py counterpart — "
                "the manifest tree and the code have drifted (rename the "
                "manifest key or export the constant)",
            )
            if f is not None:
                yield f


def _walk_string_fields(
    doc: object, keys: Sequence[str], path: str = "$"
) -> Iterable[Tuple[str, str]]:
    """Yield (json-path, value) for every string field named in
    ``keys`` anywhere in a parsed document — the one traversal behind
    both the mode-field and fault-kind scans."""
    if isinstance(doc, dict):
        for k, v in doc.items():
            if k in keys and isinstance(v, str):
                yield f"{path}.{k}", v
            yield from _walk_string_fields(v, keys, f"{path}.{k}")
    elif isinstance(doc, list):
        for idx, v in enumerate(doc):
            yield from _walk_string_fields(v, keys, f"{path}[{idx}]")


def _walk_mode_fields(
    doc: object, path: str = "$"
) -> Iterable[Tuple[str, str]]:
    """Yield (json-path, value) for every mode-valued field in a parsed
    document."""
    return _walk_string_fields(doc, _MODE_FIELDS, path)


def scenario_fault_kinds() -> Set[str]:
    """The live simlab fault vocabulary — pulled from the scenario
    schema itself so this check can never drift from the validator it
    fronts for (the labels.py treatment, applied to fault kinds)."""
    from tpu_cc_manager_torch.simlab.scenario import FAULT_PARAMS

    return set(FAULT_PARAMS)


def _walk_fault_kinds(
    doc: object, path: str = "$"
) -> Iterable[Tuple[str, str]]:
    """Yield (json-path, value) for every ``"fault": "<kind>"`` field
    in a parsed scenario document."""
    return _walk_string_fields(doc, ("fault",), path)


def _scan_scenario(
    relpath: str, raw: str, lines: Sequence[str], valid: Set[str],
    faults: Optional[Set[str]] = None,
) -> Iterable[Finding]:
    try:
        doc = json.loads(raw)
    except ValueError as e:
        f = _finding(relpath, lines, 1, f"unparseable scenario JSON: {e}")
        if f is not None:
            yield f
        return
    if faults is None:
        faults = scenario_fault_kinds()
    for path, value in _walk_fault_kinds(doc):
        if value in faults:
            continue
        lineno = (
            _find_line(lines, f'"fault": "{value}"')
            or _find_line(lines, f'"{value}"')
            or 1
        )
        f = _finding(
            relpath, lines, lineno,
            f"{path} = {value!r} is not a simlab FAULT_PARAMS kind — "
            "the scenario would be rejected at load; fix the literal "
            "or teach scenario.FAULT_PARAMS (and faults.FaultInjector) "
            "the new fault first",
        )
        if f is not None:
            yield f
    for path, value in _walk_mode_fields(doc):
        if value in valid:
            continue
        # anchor on the `"<key>": "<value>"` pair (scenarios are
        # canonically formatted), falling back to the bare value
        key = path.rsplit(".", 1)[-1]
        lineno = (
            _find_line(lines, f'"{key}": "{value}"')
            or _find_line(lines, f'"{value}"')
            or 1
        )
        f = _finding(
            relpath, lines, lineno,
            f"{path} = {value!r} is not a modes.VALID_MODES member — the "
            "scenario would be rejected at load; fix the literal or add "
            "the mode to modes.py first",
        )
        if f is not None:
            yield f


_warned_no_yaml = False


def _warn_no_yaml() -> None:
    """pyyaml missing: the structured YAML checks (CRD mode enum) are
    skipped — loudly, once, like the ruff/mypy skip notices. The regex
    key scan still runs, so the acceptance-critical direction holds."""
    global _warned_no_yaml
    if not _warned_no_yaml:
        _warned_no_yaml = True
        print(
            "ccaudit: pyyaml not installed; skipping the structured "
            "manifest checks (pip install -r requirements-dev.txt)",
            file=sys.stderr,
        )


def _crd_mode_enums(doc: object) -> Iterable[List[str]]:
    """Every ``mode: {enum: [...]}`` property in a parsed YAML document —
    the TPUCCPolicy CRD today, any CR example tomorrow."""
    if isinstance(doc, dict):
        mode = doc.get("mode")
        if isinstance(mode, dict) and isinstance(mode.get("enum"), list):
            yield mode["enum"]
        for v in doc.values():
            yield from _crd_mode_enums(v)
    elif isinstance(doc, list):
        for v in doc:
            yield from _crd_mode_enums(v)


def _scan_yaml(
    relpath: str, raw: str, lines: Sequence[str], valid: Set[str]
) -> Iterable[Finding]:
    try:
        import yaml
    except ImportError:  # pragma: no cover - pyyaml is a dev/CI dep
        _warn_no_yaml()
        return
    try:
        docs = [d for d in yaml.safe_load_all(raw) if d is not None]
    except yaml.YAMLError as e:
        # a manifest the cluster would reject is drift too — a gate that
        # quietly stops scanning is worse than none
        mark = getattr(e, "problem_mark", None)
        lineno = mark.line + 1 if mark is not None else 1
        detail = " ".join(str(e).split())
        f = _finding(
            relpath, lines, lineno,
            f"unparseable manifest YAML: {detail}",
        )
        if f is not None:
            yield f
        return
    # successive enums anchor successively (multi-document files: the
    # cursor keeps finding N from landing on enum N-1's line, which
    # would break line-based pragmas and go stale in the baseline)
    cursor = 1
    for doc in docs:
        for enum in _crd_mode_enums(doc):
            enum_set = {str(v) for v in enum}
            anchor = _find_line(lines, "enum:", cursor) or cursor
            for extra in sorted(enum_set - valid):
                f = _finding(
                    relpath, lines,
                    _find_line(lines, extra, anchor) or anchor,
                    f"CRD mode enum value {extra!r} is not a "
                    "modes.VALID_MODES member — the admission surface "
                    "accepts a mode the code rejects",
                )
                if f is not None:
                    yield f
            for missing in sorted(valid - enum_set):
                f = _finding(
                    relpath, lines, anchor,
                    f"CRD mode enum is missing {missing!r} — modes.py "
                    "learned a mode the admission surface still rejects; "
                    "regenerate the manifests",
                )
                if f is not None:
                    yield f
            cursor = anchor + 1


def manifest_findings(
    root: str,
    globs: Sequence[str] = MANIFEST_GLOBS,
    known_keys: Optional[Set[str]] = None,
    valid_modes: Optional[Set[str]] = None,
    known_faults: Optional[Set[str]] = None,
) -> List[Finding]:
    """Run the cross-check over ``root``. ``known_keys`` /
    ``valid_modes`` / ``known_faults`` default to the live labels.py /
    modes.py / simlab schema exports; tests inject their own to build
    drift fixtures."""
    known = code_protocol_keys() if known_keys is None else set(known_keys)
    valid = set(VALID_MODES) if valid_modes is None else set(valid_modes)
    faults = (scenario_fault_kinds() if known_faults is None
              else set(known_faults))

    findings: List[Finding] = []
    for pattern in globs:
        paths = sorted(_glob.glob(os.path.join(root, pattern)))
        if not paths:
            raise FileNotFoundError(
                f"manifest cross-check glob {pattern!r} matched no files "
                f"under {root}"
            )
        for path in paths:
            relpath = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                raw = f.read()
            lines = raw.splitlines()
            findings.extend(_scan_keys(relpath, lines, known))
            if relpath.endswith(".json"):
                findings.extend(
                    _scan_scenario(relpath, raw, lines, valid, faults)
                )
            else:
                findings.extend(_scan_yaml(relpath, raw, lines, valid))
    return sorted(set(findings))
