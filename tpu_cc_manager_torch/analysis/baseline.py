"""ccaudit baseline: the ratchet that lets findings only burn down.

The committed ``baseline.json`` records the findings the project has
consciously decided to live with, each pinned to (rule, file, line,
stripped source text). The gate then has two failure modes, both fatal:

- a **new** finding (not in the baseline) — the change introduced a
  violation; fix it or pragma it with a reason;
- a **stale** entry (in the baseline but no longer matching a current
  finding) — the code it suppressed moved or was fixed, so the entry
  must be deleted (``--write-baseline`` regenerates). Pinning to line
  *and* text means an entry can't silently slide onto different code
  and mask a fresh regression — the same freshness discipline the
  scenario and kustomize trees get from their gating tests.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import List, Optional, Sequence, Tuple

from tpu_cc_manager_torch.analysis.core import Finding, repo_root

#: Repo-relative path of the committed baseline.
BASELINE_PATH = "tpu_cc_manager_torch/analysis/baseline.json"

_VERSION = 1


def load_baseline(path: Optional[str] = None) -> List[dict]:
    path = path or os.path.join(repo_root(), BASELINE_PATH)
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != _VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} in {path}"
        )
    return data.get("findings", [])


def write_baseline(
    findings: Sequence[Finding], path: Optional[str] = None
) -> None:
    path = path or os.path.join(repo_root(), BASELINE_PATH)
    payload = {
        "version": _VERSION,
        "findings": [f.to_json() for f in sorted(findings)],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")


def _entry_key(entry: dict) -> Tuple[str, str, int, str]:
    return (
        entry.get("rule", ""),
        entry.get("file", ""),
        int(entry.get("line", 0)),
        entry.get("text", ""),
    )


def diff_against_baseline(
    findings: Sequence[Finding], entries: Sequence[dict]
) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """(new, suppressed, stale): findings absent from the baseline, findings
    the baseline covers, and baseline entries matching nothing current.

    Multiset semantics: two identical-key violations on one source line
    are two findings, and one baseline entry suppresses exactly one of
    them — a single entry can't silently blanket a line."""
    remaining = Counter(_entry_key(e) for e in entries)
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for f in sorted(findings):
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    current = Counter(f.key() for f in findings)
    seen: Counter = Counter()
    stale = []
    for e in entries:
        k = _entry_key(e)
        seen[k] += 1
        if seen[k] > current.get(k, 0):
            stale.append(e)
    return new, suppressed, stale
