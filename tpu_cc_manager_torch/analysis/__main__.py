"""ccaudit CLI: ``python -m tpu_cc_manager_torch.analysis``.

Exit 0 when the repo is clean against the committed baseline; exit 1 on
any new finding *or* any stale baseline entry (the ratchet only turns one
way — see baseline.py). ``make lint`` and the CI ``ccaudit`` job both run
exactly this."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from tpu_cc_manager_torch.analysis import baseline as baseline_mod
from tpu_cc_manager_torch.analysis.core import (
    DEFAULT_TARGETS,
    analyze_paths,
    on_default_surface,
    repo_root,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_cc_manager_torch.analysis",
        description="ccaudit: whole-program concurrency + protocol "
        "analyzer (lock discipline, transitive ABBA lock order, "
        "blocking-under-lock through the call graph, Eraser-style "
        "race-lockset over thread-shared state, label hygiene, "
        "exception discipline, metric-name consistency, protocol-literal "
        "confinement, unvalidated-mode taint, Mode exhaustiveness, "
        "protocol liveness, code<->manifest drift, the v4 async "
        "families: await-atomicity, lock-across-await, loop-affinity "
        "typestate, loop self-deadlock, orphan tasks, async-exception "
        "fail-secure, and the v5 jitflow families over the JAX "
        "dispatch surface: retrace hazards vs the bucket ladder, "
        "host-sync stalls in hot paths, unserialized collective "
        "dispatch, donated-buffer reuse, tracer leaks, and the v6 "
        "resourceflow families: unbounded queues, missing deadlines on "
        "the reconcile closure, retry discipline, resource leak paths, "
        "stop-aware waits). "
        "docs/analysis.md has the rule contract.",
    )
    parser.add_argument(
        "targets", nargs="*", default=list(DEFAULT_TARGETS),
        help="files/directories to scan, relative to --root "
        f"(default: {' '.join(DEFAULT_TARGETS)})",
    )
    parser.add_argument(
        "--root", default=None,
        help="repo root (default: auto-detected from the package location)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help=f"baseline file (default: <root>/{baseline_mod.BASELINE_PATH})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report and fail on every finding",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from current findings and exit 0",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON instead of text",
    )
    parser.add_argument(
        "--sarif", default=None, metavar="PATH",
        help="also write the scan as SARIF 2.1.0 to PATH (new findings "
        "level=error, baselined ones suppressed notes, stale entries "
        "stale-baseline errors) — CI uploads this so findings annotate "
        "PR diffs",
    )
    parser.add_argument(
        "--call-depth", type=int, default=None, metavar="N",
        help="transitive call-graph horizon in call edges beyond the "
        "direct callee (default: callgraph.DEPTH_LIMIT; 0 restricts "
        "summaries to the direct callee, the v2 one-hop horizon — the "
        "escape hatch when a refactor needs a different bound)",
    )
    group = parser.add_mutually_exclusive_group()
    group.add_argument(
        "--manifests", action="store_true",
        help="force the code<->manifest cross-check even with explicit "
        "targets",
    )
    group.add_argument(
        "--no-manifests", action="store_true",
        help="skip the code<->manifest cross-check (it runs by default "
        "on the default scan surface)",
    )
    parser.add_argument(
        "--files", action="store_true",
        help="changed-files mode: treat targets as an explicit file "
        "list and report ONLY findings in those files. Non-Python, "
        "missing, and off-surface paths (tests/ — the merge gate never "
        "scans them) are silently skipped: a diff includes deletions "
        "and docs. The analysis itself still runs whole-program over "
        "the default surface, so the report is exactly the full run's "
        "findings restricted to the slice — only the manifest "
        "cross-check is skipped, and stale baseline entries are "
        "ignored (entries for out-of-slice files are out of scope, "
        "not stale). `make lint-fast` wires this to the git diff.",
    )
    parser.add_argument(
        "--cache", action="store_true",
        help="route the per-module parse stage through the "
        "content-hash fact cache (<root>/.ccaudit_cache/): unchanged "
        "modules reload pickled facts, only edited ones re-parse. The "
        "whole-program passes still run fresh over every module, so a "
        "cached scan reports exactly what an uncached one would; keys "
        "embed an analyzer-source digest, so rule edits self-"
        "invalidate. `make lint-fast` turns this on.",
    )
    args = parser.parse_args(argv)

    with_manifests: Optional[bool] = None
    if args.manifests:
        with_manifests = True
    elif args.no_manifests:
        with_manifests = False

    root = os.path.abspath(args.root) if args.root else repo_root()
    baseline_path = args.baseline or os.path.join(
        root, baseline_mod.BASELINE_PATH
    )

    targets = list(args.targets)
    if args.files:
        targets = [
            t for t in targets
            if t.endswith(".py")
            and os.path.isfile(os.path.join(root, t))
            and on_default_surface(t)
        ]
        if not targets:
            print("ccaudit: --files: nothing to scan", file=sys.stderr)
            return 0

    try:
        findings = analyze_paths(
            root, targets, with_manifests, call_depth=args.call_depth,
            subset=args.files, cache=args.cache,
        )
    except FileNotFoundError as e:
        print(f"ccaudit: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        baseline_mod.write_baseline(findings, baseline_path)
        print(
            f"ccaudit: wrote {len(findings)} finding(s) to {baseline_path}"
        )
        return 0

    entries = [] if args.no_baseline else baseline_mod.load_baseline(
        baseline_path
    )
    new, suppressed, stale = baseline_mod.diff_against_baseline(
        findings, entries
    )
    if args.files:
        # the report covers only the changed slice: baseline entries
        # for files outside it are out of scope, not stale
        stale = []

    if args.sarif:
        from tpu_cc_manager_torch.analysis import sarif as sarif_mod

        sarif_mod.write_sarif(args.sarif, new, suppressed, stale)

    if args.as_json:
        print(json.dumps(
            {
                "new": [f.to_json() for f in new],
                "suppressed": [f.to_json() for f in suppressed],
                "stale": stale,
            },
            indent=1, sort_keys=True,
        ))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(
                f"{e.get('file')}:{e.get('line')}: [stale-baseline] entry "
                f"for rule {e.get('rule')!r} matches no current finding — "
                "delete it (or --write-baseline)"
            )
        print(
            f"ccaudit: {len(new)} new finding(s), {len(stale)} stale "
            f"baseline entr{'y' if len(stale) == 1 else 'ies'}, "
            f"{len(suppressed)} baselined",
            file=sys.stderr,
        )
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
