"""ccaudit whole-program call graph (v3).

v1/v2 bounded every interprocedural question to "one hop, same module,
matched by terminal name". That bound made a lock acquired two calls
deep — or in another module — invisible to every rule. This module is
the replacement: a project-wide call graph over the scanned tree, built
from the per-function records ``rules.audit_module`` collects.

Resolution is deliberately *nominal*, not points-to:

- ``self.m()``      → the enclosing class's method (same module);
- ``name()``        → a nested ``def`` in the lexical function chain,
  else the module's top-level function;
- ``mod.f()`` / ``pkg.mod.f()`` → the scanned module's top-level
  function, through import aliases (``core.collect_imports``);
- ``mod.Cls.m()`` / ``Cls.m()`` → a class method; a bare ``Cls(...)``
  call resolves to ``Cls.__init__``;
- ``x.m()`` where ``x = Cls(...)`` earlier in the same module → the
  typed-local hop (``fleet = FleetController(...)``;
  ``Thread(target=fleet.run)``).

Anything else (attribute calls on unknown objects, dynamic dispatch)
stays unresolved: the graph under-approximates reachability rather than
drowning the rules in false edges.

Traversals are **cycle-safe** (visited sets) and **depth-bounded**:
``DEPTH_LIMIT`` call edges beyond the direct callee by default,
overridable per run (``--call-depth`` on the CLI — the escape hatch
when a refactor needs a deeper or shallower horizon; ``--call-depth 0``
restricts every summary to the direct callee, i.e. the old v2 one-hop
horizon with real cross-module resolution).

Built on the graph here:

- ``transitive_entry_locks`` — every lock a callee's transitive closure
  acquires while holding nothing, feeding ``lockgraph.py``'s order
  edges (cross-module ABBA detection);
- ``blocking_findings`` — a call made under a held lock to a function
  whose closure reaches a blocking site (``time.sleep``, subprocess,
  socket/HTTP, executor waits) is a ``blocking-under-lock`` finding at
  the call site, no matter how many hops down the sleep lives.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from tpu_cc_manager_torch.analysis.core import Finding
from tpu_cc_manager_torch.analysis.rules import (
    BlockSite,
    CallRecord,
    FnAudit,
    LockSite,
    ModuleAudit,
)

#: Default traversal horizon, in call edges. Deep enough for the
#: engine's reconcile → plan → flip → device chains; bounded so a
#: pathological resolution mistake cannot pull the whole repo into one
#: function's summary. Override per run with ``--call-depth``.
DEPTH_LIMIT = 12


class CallGraph:
    """Whole-program call graph over the scanned modules."""

    def __init__(
        self, audits: Sequence[ModuleAudit], depth: int = DEPTH_LIMIT
    ):
        self.depth = depth
        self.audits = list(audits)
        #: dotted module path -> audit
        self.modules: Dict[str, ModuleAudit] = {
            a.dotted: a for a in audits
        }
        #: fn qual -> record / owning audit
        self.fns: Dict[str, FnAudit] = {}
        self.owner: Dict[str, ModuleAudit] = {}
        #: (module, fn name) -> qual for top-level functions
        self._top: Dict[Tuple[str, str], str] = {}
        #: (module, class name, method name) -> qual
        self._methods: Dict[Tuple[str, str, str], str] = {}
        #: (module, scope tuple, name) -> qual for nested defs
        self._nested: Dict[Tuple[str, Tuple[str, ...], str], str] = {}
        for a in audits:
            for fn in a.functions:
                if fn.name == "<module>":
                    continue
                self.fns[fn.qual] = fn
                self.owner[fn.qual] = a
                if not fn.scope:
                    self._top[(a.dotted, fn.name)] = fn.qual
                if fn.cls is not None and fn.scope and fn.scope[-1] == fn.cls:
                    self._methods[(a.dotted, fn.cls, fn.name)] = fn.qual
                self._nested[(a.dotted, fn.scope, fn.name)] = fn.qual
        #: resolved adjacency
        self._adj: Dict[str, List[str]] = {}
        for a in audits:
            for fn in a.functions:
                out: List[str] = []
                seen: Set[str] = set()
                for call in fn.calls:
                    q = self.resolve_call(a, fn, call)
                    if q is not None and q not in seen:
                        seen.add(q)
                        out.append(q)
                self._adj[fn.qual] = out
        self._link_param_callbacks()

    # ------------------------------------- parameter-callback linking

    def _link_param_callbacks(self) -> None:
        """Callbacks run where they are *called*, not where they are
        passed. For every reference-shaped argument that lands on a
        parameter the callee later calls — directly (``flip_one(item)``
        in flipexec's worker), through a stored attribute
        (``self.on_promoted()`` in the leader elector's thread), through
        a callback table (``self.routes[path]()``), or through a queue
        (``task = self._q.get(); task()``) — add a call-graph edge from
        the *calling site's* function to the referenced function, so
        thread contexts propagate to the callback."""
        # param → fns (incl. nested defs) that call it bare
        param_sites: Dict[str, Dict[str, List[str]]] = {}
        # (mod, class) → attr → fns calling through the attr
        attr_sites: Dict[Tuple[str, str], Dict[str, List[str]]] = {}
        # (mod, class) → attr → param names stored into it, per method
        attr_stores: Dict[str, List[Tuple[str, str]]] = {}
        for a in self.audits:
            for fn in a.functions:
                if fn.name == "<module>":
                    continue
                if fn.params:
                    prefix = fn.scope + (fn.name,)
                    sites: Dict[str, List[str]] = {}
                    for g in a.functions:
                        if g.qual != fn.qual and (
                            g.scope[: len(prefix)] != prefix
                        ):
                            continue
                        for call in g.calls:
                            if call.bare in fn.params:
                                sites.setdefault(call.bare, []).append(
                                    g.qual
                                )
                    if sites:
                        param_sites[fn.qual] = sites
                for call in fn.calls:
                    recv_cls = call.cls if call.cls is not None else fn.cls
                    if (
                        recv_cls is not None
                        and call.attr_self is not None
                        and (a.dotted, recv_cls, call.attr_self)
                        not in self._methods
                    ):
                        attr_sites.setdefault(
                            (a.dotted, recv_cls), {}
                        ).setdefault(call.attr_self, []).append(fn.qual)
                if fn.param_attr_stores:
                    attr_stores[fn.qual] = list(fn.param_attr_stores)

        extra: Dict[str, Set[str]] = {}
        for a in self.audits:
            for fn in a.functions:
                for call in fn.calls:
                    if not call.arg_refs:
                        continue
                    callee = self.resolve_call(a, fn, call)
                    if callee is None:
                        continue
                    target = self.fns.get(callee)
                    if target is None:
                        continue
                    owner = self.owner[callee]
                    for ref in call.arg_refs:
                        ref_qual = self.resolve_parts(
                            a.dotted,
                            ref.cls if ref.cls is not None else fn.cls,
                            attr_self=ref.attr_self,
                            bare=ref.bare,
                            dotted=ref.dotted,
                            scope=fn.scope,
                            scope_kinds=fn.scope_kinds,
                            fn_name=fn.name,
                        )
                        if ref_qual is None:
                            continue
                        for pname in self._landing_params(target, ref.pos):
                            for site in param_sites.get(callee, {}).get(
                                pname, ()
                            ):
                                extra.setdefault(site, set()).add(ref_qual)
                            if target.cls is None:
                                continue
                            for sp, attr in attr_stores.get(callee, ()):
                                if sp != pname:
                                    continue
                                table = attr_sites.get(
                                    (owner.dotted, target.cls), {}
                                )
                                for site in table.get(attr, ()):
                                    extra.setdefault(site, set()).add(
                                        ref_qual
                                    )
        for site, targets in extra.items():
            cur = self._adj.setdefault(site, [])
            for t in sorted(targets):
                if t not in cur:
                    cur.append(t)

    @staticmethod
    def _landing_params(target: "FnAudit", pos: "int | str") -> List[str]:
        """Callee params a call-site argument may land on; methods are
        tried under both self-shifted alignments (the dataflow summary
        convention)."""
        if isinstance(pos, str):
            return [pos] if pos in target.params else []
        shifted = bool(target.params) and target.params[0] in (
            "self", "cls"
        )
        offsets = {0, 1} if shifted else {0}
        return [
            target.params[pos + off]
            for off in offsets
            if pos + off < len(target.params)
        ]

    # ------------------------------------------------------- resolution

    def resolve_parts(
        self,
        mod: str,
        cls: Optional[str],
        *,
        attr_self: Optional[str] = None,
        bare: Optional[str] = None,
        dotted: Optional[str] = None,
        scope: Tuple[str, ...] = (),
        scope_kinds: Tuple[str, ...] = (),
        fn_name: Optional[str] = None,
    ) -> Optional[str]:
        """Resolve one reference to a function qual, or None."""
        if attr_self is not None and cls is not None:
            return self._methods.get((mod, cls, attr_self))
        if bare is not None:
            q = self._resolve_bare(mod, scope, scope_kinds, fn_name, bare)
            if q is not None:
                return q
            return self._top.get((mod, bare))
        if dotted is not None:
            return self._resolve_dotted(mod, dotted)
        return None

    def _resolve_bare(
        self,
        mod: str,
        scope: Tuple[str, ...],
        scope_kinds: Tuple[str, ...],
        fn_name: Optional[str],
        name: str,
    ) -> Optional[str]:
        """Nested-def lookup through the *function* scope chain (class
        bodies are not name scopes in Python)."""
        chain = scope + ((fn_name,) if fn_name else ())
        kinds = scope_kinds + (("fn",) if fn_name else ())
        for i in range(len(chain), 0, -1):
            if kinds[i - 1] != "fn":
                continue
            q = self._nested.get((mod, chain[:i], name))
            if q is not None:
                return q
        return None

    def _resolve_dotted(self, caller_mod: str, path: str) -> Optional[str]:
        parts = path.split(".")
        # longest scanned-module prefix wins
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod not in self.modules:
                continue
            rest = parts[i:]
            if len(rest) == 1:
                q = self._top.get((mod, rest[0]))
                if q is not None:
                    return q
                # `Cls(...)` → its __init__
                return self._methods.get((mod, rest[0], "__init__"))
            if len(rest) == 2:
                return self._methods.get((mod, rest[0], rest[1]))
            return None
        # `Cls.m(...)` on a class of the caller's own module
        if len(parts) == 2:
            return self._methods.get((caller_mod, parts[0], parts[1]))
        return None

    def resolve_call(
        self, audit: ModuleAudit, fn: FnAudit, call: CallRecord
    ) -> Optional[str]:
        recv_cls = call.cls if call.cls is not None else fn.cls
        if call.attr_self is not None and recv_cls is not None:
            q = self._methods.get((audit.dotted, recv_cls, call.attr_self))
            if q is not None:
                return q
        if call.bare is not None:
            return self.resolve_parts(
                audit.dotted, fn.cls, bare=call.bare, scope=fn.scope,
                scope_kinds=fn.scope_kinds, fn_name=fn.name,
            )
        for cand in (call.recv_class, call.resolved):
            if cand is not None:
                q = self._resolve_dotted(audit.dotted, cand)
                if q is not None:
                    return q
        return None

    # ------------------------------------------------------- traversals

    def callees(self, qual: str) -> List[str]:
        return self._adj.get(qual, [])

    def reachable(
        self, roots: Iterable[str], depth: Optional[int] = None
    ) -> Set[str]:
        """Quals reachable from ``roots`` (inclusive) within ``depth``
        call edges; cycle-safe."""
        limit = self.depth if depth is None else depth
        frontier = [q for q in roots if q in self._adj or q in self.fns]
        seen: Set[str] = set(frontier)
        for _ in range(limit):
            nxt: List[str] = []
            for q in frontier:
                for callee in self._adj.get(q, ()):
                    if callee not in seen:
                        seen.add(callee)
                        nxt.append(callee)
            if not nxt:
                break
            frontier = nxt
        return seen

    def transitive_entry_locks(self, qual: str) -> List[LockSite]:
        """Every lock the closure of ``qual`` acquires while holding
        nothing — what a caller holding X orders X ahead of."""
        out: List[LockSite] = []
        for q in sorted(self.reachable([qual])):
            fn = self.fns.get(q)
            if fn is not None:
                out.extend(fn.entry_locks)
        return out

    def first_blocking(
        self, qual: str
    ) -> Optional[Tuple[str, BlockSite]]:
        """(function qual, site) of the nearest unsuppressed blocking
        site in the closure of ``qual`` (BFS order), or None."""
        frontier = [qual]
        seen = {qual}
        for _ in range(self.depth + 1):
            nxt: List[str] = []
            for q in frontier:
                fn = self.fns.get(q)
                if fn is not None:
                    for site in fn.blocking:
                        if not site.suppressed:
                            return q, site
                for callee in self._adj.get(q, ()):
                    if callee not in seen:
                        seen.add(callee)
                        nxt.append(callee)
            if not nxt:
                return None
            frontier = nxt
        return None


def build(
    audits: Sequence[ModuleAudit], depth: int = DEPTH_LIMIT
) -> CallGraph:
    return CallGraph(audits, depth)


def callers_map(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> Dict[str, Set[str]]:
    """Reverse edge map: callee qual → quals of every function with a
    resolved call to it. The v4 asyncflow pass runs its loop-confinement
    fixpoint over this (a sync function is loop-confined iff every
    resolved caller is a coroutine or itself loop-confined); unresolved
    dynamic calls simply contribute no edge, which errs MIXED — the
    conservative side for loop-affinity."""
    out: Dict[str, Set[str]] = {}
    for audit in audits:
        for fn in audit.functions:
            for call in fn.calls:
                callee = graph.resolve_call(audit, fn, call)
                if callee is not None:
                    out.setdefault(callee, set()).add(fn.qual)
    return out


def blocking_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> List[Finding]:
    """Transitive ``blocking-under-lock``: a call made while a lock is
    held, to a function whose transitive closure reaches a blocking
    site. The lexical case (the blocking call itself under the lock) is
    rules.py's finding; this pass anchors at the *call site* so the fix
    — move the call out of the critical section — is where the finding
    points."""
    findings: List[Finding] = []
    for audit in audits:
        for fn in audit.functions:
            for call in fn.calls:
                if call.held is None:
                    continue
                callee = graph.resolve_call(audit, fn, call)
                if callee is None:
                    continue
                hit = graph.first_blocking(callee)
                if hit is None:
                    continue
                where, site = hit
                if audit.module.suppressed("blocking-under-lock", call.line):
                    continue
                display = callee.rsplit(".", 2)
                short = ".".join(display[-2:])
                findings.append(
                    Finding(
                        file=audit.module.relpath,
                        line=call.line,
                        rule="blocking-under-lock",
                        message=(
                            f"call to {short}() while holding "
                            f"{call.held.display} (acquired line "
                            f"{call.held.line}) reaches {site.what} at "
                            f"{site.file}:{site.line} — a blocking call "
                            "is still blocking N hops down; move it out "
                            "of the critical section"
                        ),
                        text=audit.module.line_text(call.line),
                    )
                )
    return findings
