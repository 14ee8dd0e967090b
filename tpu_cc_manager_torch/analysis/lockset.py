"""ccaudit static lockset race analyzer (v3).

The Eraser discipline (PAPERS.md: lockset/happens-before detectors),
transplanted from a dynamic tool to a static pass over the call graph:
every location shared between threads must have a lock that is held on
every write. Statically:

- **locations** are ``self.``-attributes (keyed by module + class +
  name, including accesses through ``outer = self`` closure aliases)
  and mutable module globals;
- a location is **shared** when its accesses span more than one thread
  context — two different roots from ``threads.infer_roots``, a root
  plus main-thread code, or a single *self-concurrent* root (executor
  workers, per-request handlers, loop-spawned threads);
- the **lockset of an access** is the set of lock quals held lexically
  at the site; the guard discipline of a location is the intersection
  of its write locksets (the lattice: ⊤ = all locks before the first
  write, ∩ at each write, ⊥ = ∅ = racy).

A shared location **written** with an empty lockset, or whose write
locksets have an empty intersection (two writers under *different*
locks), is a ``race-lockset`` finding at the write site.

Recognized non-races (no finding):

- **reads-only sharing** — locations never written outside init;
- **init-before-spawn** — writes in ``__init__``/module top level, and
  writes lexically before the first ``.start()`` in a function that
  spawns a thread;
- **consistently guarded writes** with unguarded reads: under the GIL a
  single attribute load is atomic, and flagging every bare read would
  drown the write-side signal (the deliberate deviation from Eraser —
  docs/analysis.md §v3 walks through an example).

Deliberate benign races (monotonic latches, best-effort counters whose
loss is acceptable) carry ``# ccaudit: allow-race-lockset(reason)`` on
the write line.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from tpu_cc_manager_torch.analysis.callgraph import CallGraph
from tpu_cc_manager_torch.analysis.core import Finding
from tpu_cc_manager_torch.analysis.rules import AccessSite, ModuleAudit
from tpu_cc_manager_torch.analysis.threads import MAIN, ThreadRoot, contexts

RULE = "race-lockset"

#: (module dotted, "attr"/"global", class-or-"", name)
LocationKey = Tuple[str, str, str, str]


def _location_key(mod: str, access: AccessSite) -> LocationKey:
    if access.key[0] == "attr":
        return (mod, "attr", access.key[1], access.key[2])
    return (mod, "global", "", access.key[1])


def _display(key: LocationKey) -> str:
    mod_base = key[0].rsplit(".", 1)[-1]
    if key[1] == "attr":
        return f"{mod_base}.{key[2]}.{key[3]}"
    return f"{mod_base}.{key[3]}"


def _root_names(ctx: Set[str]) -> str:
    short = sorted(
        q.rsplit(".", 1)[-1] if q != MAIN else "main" for q in ctx
    )
    return ", ".join(short[:4]) + ("…" if len(short) > 4 else "")


def _caller_held(
    audits: Sequence[ModuleAudit],
    graph: CallGraph,
    roots: Dict[str, ThreadRoot],
) -> Dict[str, FrozenSet[str]]:
    """Locks provably held on EVERY resolved call path into a function
    (the ``_locked``-suffix convention: ``_note_outcome_locked`` is
    guarded by its callers' ``with self._active_lock:``). Computed as a
    depth-bounded intersection fixpoint: held(F) = ⋂ over call sites of
    (locks lexically held at the site ∪ held(caller)).

    A thread ROOT is pinned to ∅ regardless of its call sites: the
    Thread-spawn entry path holds nothing, so a root that also happens
    to be called under a lock (``scan_once`` spawned AND called from
    the run loop) must not have its writes laundered as guarded."""
    call_sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for audit in audits:
        for fn in audit.functions:
            for call in fn.calls:
                callee = graph.resolve_call(audit, fn, call)
                if callee is not None and callee not in roots:
                    call_sites.setdefault(callee, []).append(
                        (fn.qual, call.held_locks)
                    )
    held: Dict[str, FrozenSet[str]] = {}
    for _ in range(graph.depth):
        changed = False
        for callee, sites in call_sites.items():
            acc: FrozenSet[str] = frozenset()
            for i, (caller, locks) in enumerate(sites):
                path = locks | held.get(caller, frozenset())
                acc = path if i == 0 else (acc & path)
            if acc != held.get(callee, frozenset()):
                held[callee] = acc
                changed = True
        if not changed:
            break
    return held


#: Public seam for the v4 asyncflow pass (``analysis/asyncflow.py``):
#: the await-atomicity family widens coroutine locksets with the same
#: caller-held ⋂-fixpoint, so the ``_locked``-suffix convention means
#: one thing across both concurrency models.
caller_held_locks = _caller_held


def race_findings(
    audits: Sequence[ModuleAudit],
    graph: CallGraph,
    roots: Dict[str, ThreadRoot],
    async_lock_quals: FrozenSet[str] = frozenset(),
) -> List[Finding]:
    fn_ctx = contexts(graph, roots)
    caller_held = _caller_held(audits, graph, roots)

    # gather all accesses per location, widening each access's lockset
    # with the locks every caller provably holds around its function
    sites: Dict[LocationKey, List[AccessSite]] = {}
    for audit in audits:
        for fn in audit.functions:
            inherited = caller_held.get(fn.qual, frozenset())
            for a in fn.accesses:
                if inherited:
                    a = AccessSite(
                        key=a.key, kind=a.kind,
                        locks=a.locks | inherited, init=a.init,
                        fn_qual=a.fn_qual, file=a.file, line=a.line,
                        text=a.text, suppressed=a.suppressed,
                        prespawn=a.prespawn,
                    )
                sites.setdefault(_location_key(audit.dotted, a), []).append(a)

    def _prespawn_safe(a: AccessSite) -> bool:
        """A pre-``.start()`` write happens-before the spawned thread —
        but only shields the location when the spawning function itself
        runs in one non-self-concurrent context (two concurrent
        ``respawn()`` calls still tear the write)."""
        if not a.prespawn:
            return False
        ctx = fn_ctx.get(a.fn_qual) or {MAIN}
        if len(ctx) > 1:
            return False
        return not any(roots[r].self_concurrent for r in ctx if r in roots)

    findings: List[Finding] = []
    for key in sorted(sites):
        # init accesses happen-before every spawn: they neither fire
        # nor establish a thread context; qualifying prespawn writes
        # get the same treatment
        accesses = [
            a for a in sites[key] if not a.init and not _prespawn_safe(a)
        ]
        if not accesses:
            continue
        ctx_of: List[Set[str]] = [
            fn_ctx.get(a.fn_qual) or {MAIN} for a in accesses
        ]
        all_ctx: Set[str] = set().union(*ctx_of)
        if len(all_ctx) < 2 and not any(
            roots[r].self_concurrent for r in all_ctx if r in roots
        ):
            continue  # single-threaded location
        # a pragma'd write asserts an out-of-band happens-before (e.g.
        # prime() before the watcher thread starts) — it neither fires
        # nor drags its context into the race computation
        writes = [
            (a, c) for a, c in zip(accesses, ctx_of)
            if a.kind == "write" and not a.suppressed
        ]
        if not writes:
            continue  # reads-only sharing (plus init writes): fine
        # fire only on the lost-update shape: writes racing writes.
        # A single writer thread with unguarded readers is tolerated —
        # under the GIL a one-slot store/load is atomic, and flagging
        # every bare read would drown the signal (docs/analysis.md §v3)
        write_ctx: Set[str] = set().union(*(c for _, c in writes))
        write_self_concurrent = any(
            roots[r].self_concurrent for r in write_ctx if r in roots
        )
        if len(write_ctx) < 2 and not write_self_concurrent:
            continue
        # the lockset lattice: ∩ of write locksets. An asyncio lock
        # excludes coroutines on ONE loop, not threads — so v4 passes
        # the async-lock quals in and they are discounted here: a write
        # "guarded" only by an asyncio.Lock is unguarded thread-wise.
        write_locksets: List[FrozenSet[str]] = [
            a.locks - async_lock_quals for a, _ in writes
        ]
        common: FrozenSet[str] = write_locksets[0]
        for ls in write_locksets[1:]:
            common = common & ls
        consistent = bool(common)
        for (access, _), eff in zip(writes, write_locksets):
            if eff and consistent:
                continue
            if eff:
                others = sorted(
                    set().union(*(ls for ls in write_locksets)) - eff
                )
                message = (
                    f"{_display(key)} is written under "
                    f"{{{', '.join(sorted(eff))}}} here but "
                    f"under {{{', '.join(others)}}} elsewhere — the write "
                    "locksets share no common lock, so the location is "
                    "unprotected (shared across: "
                    f"{_root_names(all_ctx)})"
                )
            else:
                message = (
                    f"{_display(key)} is written with no lock held while "
                    f"shared across thread contexts "
                    f"({_root_names(all_ctx)}) — a lost update or torn "
                    "read-modify-write at fleet scale; guard every write "
                    "with one lock, or annotate "
                    "`# ccaudit: allow-race-lockset(reason)`"
                )
            findings.append(
                Finding(
                    file=access.file,
                    line=access.line,
                    rule=RULE,
                    message=message,
                    text=access.text,
                )
            )
    return sorted(set(findings))
