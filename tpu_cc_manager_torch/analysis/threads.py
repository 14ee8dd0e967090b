"""ccaudit thread-root inference (v3).

The runtime is genuinely concurrent: ~10 long-lived ``threading.Thread``
roots (fleet watch, policy CR/node watchers, webhook serve + cert
reload, agent event recorder, watch pump, simlab replicas), the
flipexec executor workers, and ThreadingHTTPServer per-request handler
threads. This module recovers those roots *statically* from the
per-function records ``rules.audit_module`` collects:

- every resolvable ``threading.Thread(target=…)`` (``self._run``,
  ``fleet.run`` through a typed local, a nested ``worker`` def);
- every executor ``…submit(fn, …)`` first argument — including the
  flipexec worker entry (``pool.submit(worker, item)``);
- ``do_*`` methods of ``*RequestHandler`` subclasses (the stdlib spawn
  site is invisible, but ThreadingHTTPServer runs each request on its
  own thread).

Escaped callbacks (a ``self.``-method handed to a runner, stored in a
callback table, or routed through a queue) are NOT separate roots:
``callgraph._link_param_callbacks`` gives them call-graph edges from
the site that actually *calls* them, so they inherit the right root's
context — flipexec's ``flip_one`` lands under the submit-root worker,
while a callback driven synchronously stays in its caller's context.

A root is ``self_concurrent`` when it races *itself* — spawned in a
loop, submitted to an executor, or a per-request handler. The lockset
pass (``lockset.py``) treats functions reachable from two distinct
roots — or from one self-concurrent root — as multi-threaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set

from tpu_cc_manager_torch.analysis.callgraph import CallGraph
from tpu_cc_manager_torch.analysis.rules import ModuleAudit

#: Pseudo-root id for code not reachable from any inferred thread root —
#: the spawning/main thread's context.
MAIN = "<main>"

#: Pseudo-root id for the bridge event-loop thread: every ``async def``
#: executes here (the process runs ONE loop — aio_bridge's singleton).
#: The v4 asyncflow pass seeds its loop-confinement fixpoint from these.
LOOP = "<loop>"

#: kinds in confidence order (kept on merge)
_KIND_RANK = {"thread": 0, "submit": 1, "handler": 2}


@dataclass
class ThreadRoot:
    qual: str  #: entry function
    kind: str  #: "thread" | "submit" | "handler"
    file: str
    line: int
    #: True when instances of this root run concurrently with each
    #: other (loop-spawned, executor-submitted, per-request)
    self_concurrent: bool


def infer_roots(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> Dict[str, ThreadRoot]:
    """qual -> root, merged across spawn sites (strongest kind wins,
    ``self_concurrent`` is sticky)."""
    roots: Dict[str, ThreadRoot] = {}

    def add(root: ThreadRoot) -> None:
        cur = roots.get(root.qual)
        if cur is None:
            roots[root.qual] = root
            return
        cur.self_concurrent = cur.self_concurrent or root.self_concurrent
        if _KIND_RANK[root.kind] < _KIND_RANK[cur.kind]:
            cur.kind = root.kind

    for audit in audits:
        for fn in audit.functions:
            if fn.handler_root:
                add(ThreadRoot(
                    qual=fn.qual, kind="handler",
                    file=audit.module.relpath, line=fn.line,
                    self_concurrent=True,
                ))
            for ref in fn.refs:
                qual = graph.resolve_parts(
                    audit.dotted,
                    ref.cls if ref.cls is not None else fn.cls,
                    attr_self=ref.attr_self,
                    bare=ref.bare,
                    dotted=ref.recv_class or ref.resolved,
                    scope=fn.scope,
                    scope_kinds=fn.scope_kinds,
                    fn_name=fn.name,
                )
                if qual is None:
                    continue
                add(ThreadRoot(
                    qual=qual, kind=ref.kind,
                    file=audit.module.relpath, line=ref.line,
                    self_concurrent=ref.self_concurrent
                    or ref.kind == "submit",
                ))
    return roots


def contexts(
    graph: CallGraph, roots: Dict[str, ThreadRoot]
) -> Dict[str, Set[str]]:
    """fn qual -> set of root quals it is reachable from. Functions in
    no root's closure belong to the ``MAIN`` pseudo-context (the
    lockset pass fills that in per access).

    A root that lies wholly inside another root's closure (``scan_once``
    is spawned as a one-shot bench thread AND called from the run loop)
    is *subsumed*: labelling its closure twice would make one code path
    look like two racing threads. Self-concurrent roots are never
    subsumed — they race themselves regardless of who else calls them.
    Mutually-reachable roots (two thread entries that call into each
    other) subsume each other symmetrically, so the smallest qual of
    each mutual group is kept — dropping the whole group would make
    genuinely two-threaded code look single-threaded.
    """
    reach = {q: graph.reachable([q]) for q in roots}

    def strictly_subsumed(q: str) -> bool:
        return any(
            q in reach[o] and o not in reach[q]
            for o in roots if o != q
        )

    effective = []
    for q, r in roots.items():
        if r.self_concurrent:
            effective.append(q)
            continue
        if strictly_subsumed(q):
            continue
        mutual = [
            o for o in roots
            if o != q and q in reach[o] and o in reach[q]
            and not strictly_subsumed(o)
        ]
        # mutual group: kept only by its smallest non-subsumed member,
        # which becomes self-concurrent — the group is ≥2 OS threads
        # executing one shared closure, exactly the race-with-itself
        # shape (dropping the label would hide it entirely)
        if any(o < q for o in mutual):
            continue
        if mutual:
            r.self_concurrent = True
        effective.append(q)
    ctx: Dict[str, Set[str]] = {}
    for root_qual in effective:
        for q in reach[root_qual]:
            ctx.setdefault(q, set()).add(root_qual)
    return ctx


def async_roots(audits: Sequence[ModuleAudit]) -> Set[str]:
    """Quals of every ``async def`` — each is an entry point onto the
    process's one event loop (the ``LOOP`` pseudo-context). The v4
    asyncflow pass seeds loop-confinement from this set: a sync
    function all of whose resolved callers live here (transitively) is
    provably loop-confined."""
    return {
        fn.qual
        for audit in audits
        for fn in audit.functions
        if fn.is_async
    }


def shared_functions(
    graph: CallGraph, roots: Dict[str, ThreadRoot]
) -> List[str]:
    """Quals reachable from more than one root (diagnostics/tests)."""
    ctx = contexts(graph, roots)
    return sorted(q for q, c in ctx.items() if len(c) > 1)
