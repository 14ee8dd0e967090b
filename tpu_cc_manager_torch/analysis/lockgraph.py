"""ccaudit lock-order graph: ABBA-cycle detection over ``with`` nesting.

Nodes are module/class-qualified lock names (``agent.Agent._event_lock``).
Edges come from two sources:

- **lexical nesting** — ``with a:`` containing ``with b:`` adds a→b;
- **a transitive call summary** (v3) — a call made while ``a`` is held,
  resolved through the whole-program call graph (``callgraph.py``:
  module attributes, ``self.``-methods, nested defs, typed locals),
  adds a→b for every lock ``b`` the callee's transitive closure
  acquires while holding nothing. The closure is cycle-safe and
  depth-bounded (``callgraph.DEPTH_LIMIT``, ``--call-depth`` on the
  CLI is the escape hatch; ``--call-depth 0`` restricts summaries to
  the direct callee — the old v2 one-hop horizon).

All modules' edges land in one global graph, so an inversion between,
say, ``engine`` and ``simlab`` helpers shows up even when each side of
the cycle lives behind two calls in different modules. A cycle means two
threads can acquire the same locks in opposite orders — the classic ABBA
deadlock that only fires under fleet-scale contention.

A self-edge (a lock re-acquired while already held, lexically or through
any resolved call chain) is reported unless the lock is known reentrant
(``RLock``/``Condition``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set, Tuple

from tpu_cc_manager_torch.analysis.core import Finding

if TYPE_CHECKING:  # pragma: no cover - typing only (no runtime cycle risk)
    from tpu_cc_manager_torch.analysis.callgraph import CallGraph
    from tpu_cc_manager_torch.analysis.rules import LockSite, ModuleAudit

RULE = "lock-order"


def _edges(
    audits: Sequence["ModuleAudit"], graph: Optional["CallGraph"]
) -> Dict[Tuple[str, str], "LockSite"]:
    """(outer_qual, inner_qual) -> evidence LockSite of the inner acquire,
    keeping the lexically-first evidence per edge for stable output."""
    edges: Dict[Tuple[str, str], "LockSite"] = {}

    def add(a: str, b: str, evidence: "LockSite") -> None:
        key = (a, b)
        cur = edges.get(key)
        if cur is None or (evidence.file, evidence.line) < (cur.file, cur.line):
            edges[key] = evidence

    for audit in audits:
        for outer, inner in audit.lock_edges:
            add(outer.qual, inner.qual, inner)
        if graph is None:
            continue
        # v2-parity fallback for receivers the graph cannot resolve:
        # same-module functions matched by terminal name, direct entry
        # locks only (one hop, no transitivity — the old horizon is a
        # strict floor, same contract as dataflow's fallback)
        by_name: Dict[str, List["LockSite"]] = {}
        for fn in audit.functions:
            if fn.entry_locks:
                by_name.setdefault(fn.name, []).extend(fn.entry_locks)
        for fn in audit.functions:
            for call in fn.calls:
                if call.held is None:
                    continue
                callee = graph.resolve_call(audit, fn, call)
                if callee is not None:
                    for site in graph.transitive_entry_locks(callee):
                        add(call.held.qual, site.qual, site)
                elif call.term is not None:
                    for site in by_name.get(call.term, ()):
                        add(call.held.qual, site.qual, site)
    return edges


def _sccs(nodes: Sequence[str], adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan's strongly-connected components, iterative (analyzer input
    is arbitrary user code — no recursion-depth bets)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(sorted(comp))
    return out


def order_findings(
    audits: Sequence["ModuleAudit"], graph: Optional["CallGraph"] = None
) -> List[Finding]:
    by_relpath = {a.module.relpath: a.module for a in audits}
    edges = _edges(audits, graph)

    findings: List[Finding] = []

    def emit(evidence: "LockSite", message: str) -> None:
        mod = by_relpath.get(evidence.file)
        if mod is not None and mod.suppressed(RULE, evidence.line):
            return
        findings.append(
            Finding(
                file=evidence.file,
                line=evidence.line,
                rule=RULE,
                message=message,
                text=evidence.text,
            )
        )

    # direct non-reentrant re-acquisition (with a: ... with a:)
    for (a, b), evidence in sorted(edges.items()):
        if a == b and not evidence.reentrant:
            emit(
                evidence,
                f"{evidence.display} re-acquired while already held — "
                "a non-reentrant lock deadlocks against itself",
            )

    # two-lock inversions: both a->b and b->a exist
    reported: Set[Tuple[str, str]] = set()
    for (a, b), evidence in sorted(edges.items()):
        if a >= b or (b, a) not in edges:
            continue
        back = edges[(b, a)]
        reported.add((a, b))
        emit(
            evidence,
            f"potential ABBA deadlock: {a} and {b} are acquired in both "
            f"orders ({a}→{b} here; {b}→{a} at "
            f"{back.file}:{back.line})",
        )

    # longer cycles with no internal 2-cycle (a->b->c->a): one finding
    # per strongly-connected component, anchored at its first edge
    adj: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
    nodes = sorted(set(adj) | {b for tgts in adj.values() for b in tgts})
    for comp in _sccs(nodes, adj):
        if len(comp) < 2:
            continue
        pairs = {(a, b) for a in comp for b in comp if (a, b) in reported}
        if pairs:
            continue  # already reported as inversion(s)
        comp_edges = sorted(
            (k, v) for k, v in edges.items()
            if k[0] in comp and k[1] in comp and k[0] != k[1]
        )
        (a, b), evidence = comp_edges[0]
        emit(
            evidence,
            "potential ABBA deadlock: lock-order cycle through "
            + " → ".join(comp)
            + " (first edge here)",
        )
    return findings
