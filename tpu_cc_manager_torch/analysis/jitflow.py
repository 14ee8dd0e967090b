"""ccaudit JAX-dispatch whole-program pass (v5 "jitflow").

ROADMAP item 1 (the million-node planner: delta ticks on a multi-host
mesh) multiplies the repo's JAX dispatch surface — more jitted kernels,
donated buffers, mesh-spanning ``shard_map`` programs. v1–v4 see locks,
dataflow, threads and the event loop, but are blind to the hazard class
that dominates a jit-heavy control plane: silent retraces (a multi-second
XLA compile in the tick path), host↔device sync stalls on hot paths,
dispatch outside the ``_DISPATCH_LOCK`` contract (plan.py:746 — PR 7's
5 s rendezvous stalls), and donated-buffer reuse. This module teaches
the analyzer the dispatch model — five gated rule families over the same
per-function records and call graph the thread/async passes consume
(docs/analysis.md §v5 has the full contract):

``retrace-hazard``
    Every distinct static-argument value and every distinct input
    geometry retraces a jitted callable. The sanctioned way to feed the
    planner kernels is the power-of-two bucket ladder
    (``bucket_nodes``/``bucket_pools``), so shape/static arguments are
    classified on a three-point provenance lattice — CONST (literals,
    ``UPPER_CASE`` module constants, arithmetic over them) ⊑ BUCKETED
    (results of the bucket functions, values read off a ``.bucket``-named
    snapshot attribute, arithmetic that stays within the ladder) ⊑
    DYNAMIC (``len()``, ``.shape``, parameters, anything else). A jit
    factory (a function whose body builds a ``jax.jit`` program from its
    geometry parameters, e.g. ``plan._tick_fn``) invoked with a DYNAMIC
    geometry argument, or a jit root invoked with a DYNAMIC value at a
    ``static_argnums``/``static_argnames`` position, fires. Pragma:
    ``allow-retrace(reason)``.

``host-sync-in-hot-path``
    Implicit device→host transfers on values returned by a jitted
    callable — ``float()``/``int()``/``bool()``/``np.asarray()``/
    ``.item()``/iteration — and any ``.block_until_ready()`` reachable
    from the reconcile/scan/tick call paths each stall the dispatching
    thread on device completion. ``jax.device_get`` is the sanctioned
    explicit transfer (its result is host-side and exempt). bench/
    scripts/simlab modules are exempt — they measure or simulate, and
    blocking there is the point. Pragma: ``allow-host-sync(reason)``.

``unserialized-dispatch``
    The sharded tick is a multi-participant collective program; XLA's
    cross-module all-reduce rendezvous must not interleave from
    multiple host threads (plan.py:746). Every call site of a
    ``shard_map``-wrapped jitted callable must hold ``_DISPATCH_LOCK``
    — lexically or via the caller-held ⋂-fixpoint the race pass already
    computes (``lockset.caller_held_locks``, the ``_locked``-suffix
    convention). AOT ``.lower()``/``.compile()`` are not dispatches.
    The one guaranteed-incident shape in the family: **error** severity.

``donation-violation``
    ``donate_argnums``/``donate_argnames`` hand the argument's buffer to
    XLA — after the call the Python reference points at freed device
    memory. A read of a donated argument after the donating call (v2
    statement-order) fires. Pragma: ``allow-donation(reason)``.

``tracer-leak``
    Inside a traced function body, Python runs once per (re)trace, not
    per step: a write to a ``self.``-attribute or module global is a
    trace-time side effect (deliberate ones — the ``TRACE_COUNTS``
    retrace pin — carry a pragma), and an ``if``/``while`` on a traced
    array value raises ``TracerBoolConversionError`` at trace time.
    Conditions on ``static_argnames`` parameters, keyword-only config
    parameters, and ``is None`` defaulting are Python-level and exempt.

All five ids take ``# ccaudit: allow-<rule>(reason)`` pragmas; the
retrace/host-sync/donation families also accept the short aliases
``allow-retrace``/``allow-host-sync``/``allow-donation``. New findings
surface at SARIF level ``warning`` except ``unserialized-dispatch``
(``error``); the baseline ratchet gates them all identically.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import (
    Dict,
    FrozenSet,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from tpu_cc_manager_torch.analysis import lockset
from tpu_cc_manager_torch.analysis.callgraph import CallGraph
from tpu_cc_manager_torch.analysis.core import (
    Finding,
    Module,
    resolve_dotted,
)
from tpu_cc_manager_torch.analysis.rules import FnAudit, ModuleAudit
from tpu_cc_manager_torch.analysis.threads import ThreadRoot

RETRACE_RULE = "retrace-hazard"
SYNC_RULE = "host-sync-in-hot-path"
DISPATCH_RULE = "unserialized-dispatch"
DONATION_RULE = "donation-violation"
TRACER_RULE = "tracer-leak"

#: every v5 family, in contract order (bench stamps this count so the
#: smoke job can assert the pass actually ran)
JITFLOW_RULES = (
    RETRACE_RULE, SYNC_RULE, DISPATCH_RULE, DONATION_RULE, TRACER_RULE,
)

#: v5 ids that enter at SARIF ``warning``; ``unserialized-dispatch`` is
#: the one guaranteed-incident shape (PR 7's rendezvous stalls) and
#: stays ``error``.
WARNING_RULES = frozenset({
    RETRACE_RULE, SYNC_RULE, DONATION_RULE, TRACER_RULE,
})

#: short pragma spellings the ISSUE contract names
#: (``allow-retrace(reason)`` etc.) — accepted alongside the full ids
PRAGMA_ALIASES = {
    RETRACE_RULE: "retrace",
    SYNC_RULE: "host-sync",
    DONATION_RULE: "donation",
}

#: terminal names of the sanctioned bucket-ladder functions — their
#: results are BUCKETED by definition
_BUCKET_FNS = frozenset({"bucket_nodes", "bucket_pools",
                         "bucket_deltas"})

#: attribute names that carry a bucket by convention: a snapshot that
#: computed its own bucket exposes it under ``.bucket`` (FleetSnapshot),
#: the same way the ``_locked`` suffix carries a lockset contract
_BUCKET_ATTRS = frozenset({"bucket", "node_bucket", "pool_bucket",
                           "delta_bucket"})

#: function names that anchor the hot host paths: the controllers'
#: reconcile/scan bodies and the planner's host API. Name-matched under
#: ``tpu_cc_manager_torch/`` (simlab excluded below) so the set survives
#: refactors that move them between classes.
_HOT_ROOT_NAMES = frozenset({
    "reconcile", "scan_once", "_scan",
    "analyze_fleet", "analyze_encoding", "analyze_pools",
})

#: module prefixes exempt from the retrace + host-sync advisories:
#: benches measure sync stalls on purpose, scripts are one-shot CLIs,
#: simlab drives wall-clock scenarios. __graft_entry__ is deliberately
#: NOT exempt — its dry-run pragmas are the worked suppression example.
_EXEMPT_PREFIXES = ("bench.py", "scripts/", "tpu_cc_manager_torch/simlab/")

#: the process-wide dispatch serializer (plan.py:746) — matched by
#: terminal name so the contract survives a module move
_DISPATCH_LOCK_NAME = "_DISPATCH_LOCK"

#: provenance lattice points, in increasing order of hazard
_CONST, _BUCKETED, _DYNAMIC = 0, 1, 2
_PROV_NAMES = {_CONST: "constant", _BUCKETED: "bucketed", _DYNAMIC: "dynamic"}


def _is_exempt(relpath: str) -> bool:
    return any(
        relpath == p or relpath.startswith(p) for p in _EXEMPT_PREFIXES
    )


def _suppressed(mod: Module, rule: str, line: int) -> bool:
    if mod.suppressed(rule, line):
        return True
    alias = PRAGMA_ALIASES.get(rule)
    return alias is not None and mod.suppressed(alias, line)


def _finding(mod: Module, rule: str, line: int, message: str) -> Finding:
    return Finding(
        file=mod.relpath,
        line=line,
        rule=rule,
        message=message,
        text=mod.line_text(line),
        severity="warning" if rule in WARNING_RULES else "error",
    )


def _ordered_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Preorder, source-ordered nodes lexically inside ``fn``, not
    descending into nested defs (separate execution contexts — a nested
    def's body runs when *it* is called, not where it is defined)."""
    for child in ast.iter_child_nodes(fn):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _ordered_body(child)


# -------------------------------------------------------- jit inventory


@dataclass
class JitRoot:
    """One jitted callable binding: ``name = jax.jit(...)`` or a
    ``@jax.jit``-decorated function."""

    name: str
    #: dotted qual of the scope that owns the binding — the module for
    #: module-level roots, the enclosing function's qual for locals
    owner: str
    module: str  #: relpath
    line: int
    #: wrapped by ``shard_map`` (directly or via a wrapped local) — the
    #: collective programs the dispatch-lock contract covers
    collective: bool = False
    static_argnames: Tuple[str, ...] = ()
    static_argnums: Tuple[int, ...] = ()
    donate_argnums: Tuple[int, ...] = ()
    donate_argnames: Tuple[str, ...] = ()
    #: qual of the traced Python function, when nominally resolvable
    target: Optional[str] = None


@dataclass
class JitFactory:
    """A function whose body builds a jit program from its parameters
    (``plan._tick_fn``): every distinct argument tuple is a distinct
    compile, so its call sites are geometry sites."""

    name: str
    qual: str
    module: str
    line: int
    params: Tuple[str, ...] = ()


@dataclass
class Inventory:
    roots: List[JitRoot] = field(default_factory=list)
    factories: List[JitFactory] = field(default_factory=list)

    def visible_roots(self, fn_qual: str, moddot: str) -> Dict[str, JitRoot]:
        """Roots a bare name inside ``fn_qual`` (module ``moddot``) can
        refer to: module-level bindings of the same module plus bindings
        of any enclosing scope (closures — ``run`` sees ``_tick_fn``'s
        ``jitted``). Innermost binding wins."""
        out: Dict[str, JitRoot] = {}
        candidates = [
            r for r in self.roots
            if r.owner == moddot
            or r.owner == fn_qual
            or fn_qual.startswith(r.owner + ".")
        ]
        candidates.sort(key=lambda r: len(r.owner))
        for r in candidates:
            out[r.name] = r
        return out

    def root_by_qual(self, qual: Optional[str]) -> Optional[JitRoot]:
        """Module-level root matched by import-folded dotted path
        (``plan.fleet_plan_jit`` from another module)."""
        if not qual:
            return None
        for r in self.roots:
            if f"{r.owner}.{r.name}" == qual:
                return r
        return None

    def factory_for(
        self, bare: Optional[str], resolved: Optional[str], moddot: str
    ) -> Optional[JitFactory]:
        for f in self.factories:
            if bare and f.qual == f"{moddot}.{bare}":
                return f
            if resolved and f.qual == resolved:
                return f
        return None


def _str_tuple(node: ast.AST) -> Tuple[str, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(
            e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        )
    return ()


def _int_tuple(node: ast.AST) -> Tuple[int, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(
            e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, int)
        )
    return ()


def _call_terminal(call: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    resolved = resolve_dotted(call.func, imports)
    if resolved:
        return resolved.rsplit(".", 1)[-1]
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _is_jit_call(call: ast.Call, imports: Dict[str, str]) -> bool:
    resolved = resolve_dotted(call.func, imports) or ""
    return resolved == "jax.jit" or resolved.endswith(".jit")


def _is_shard_map_call(call: ast.Call, imports: Dict[str, str]) -> bool:
    term = _call_terminal(call, imports)
    return term is not None and term.lstrip("_") == "shard_map"


def _jit_config(call: ast.Call) -> Dict[str, Tuple]:
    cfg: Dict[str, Tuple] = {}
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            cfg["static_argnames"] = _str_tuple(kw.value)
        elif kw.arg == "static_argnums":
            cfg["static_argnums"] = _int_tuple(kw.value)
        elif kw.arg == "donate_argnums":
            cfg["donate_argnums"] = _int_tuple(kw.value)
        elif kw.arg == "donate_argnames":
            cfg["donate_argnames"] = _str_tuple(kw.value)
    return cfg


def _unwrap_partial(
    node: ast.AST, imports: Dict[str, str]
) -> Optional[ast.Call]:
    """``partial(jax.jit, ...)`` / ``partial(shard_map, ...)`` decorator
    → a synthetic Call on the inner callable carrying partial's
    keywords, so decorator detection sees one shape."""
    if not isinstance(node, ast.Call):
        return None
    resolved = resolve_dotted(node.func, imports) or ""
    if not resolved.endswith("partial") or not node.args:
        return None
    inner = ast.Call(
        func=node.args[0], args=list(node.args[1:]),
        keywords=list(node.keywords),
    )
    return ast.copy_location(inner, node)


def build_inventory(audits: Sequence[ModuleAudit]) -> Inventory:
    """One scoped walk per module containing jit/shard_map text: every
    jit binding, every shard_map wrap, every jit factory."""
    inv = Inventory()
    for audit in audits:
        mod = audit.module
        if "jit" not in mod.source and "shard_map" not in mod.source:
            continue
        _InventoryWalk(audit, inv).walk(mod.tree, audit.dotted)
    return inv


class _InventoryWalk:
    def __init__(self, audit: ModuleAudit, inv: Inventory):
        self.audit = audit
        self.mod = audit.module
        self.imports = audit.imports
        self.inv = inv

    def walk(self, scope_node: ast.AST, owner: str) -> None:
        #: local names bound to a shard_map result in this scope,
        #: mapped to the wrapped callable's bare name (if nominal)
        collective_locals: Dict[str, Optional[str]] = {}
        for node in ast.iter_child_nodes(scope_node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(node, owner)
            elif isinstance(node, ast.ClassDef):
                self.walk(node, f"{owner}.{node.name}")
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self._assign(
                    node.targets[0].id, node.value, node, owner,
                    collective_locals,
                )
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For,
                                   ast.While)):
                # bindings behind guards (`try: from jax import ...`)
                # still bind the scope's name
                self.walk_stmts(node, owner, collective_locals)

    def walk_stmts(
        self, node: ast.AST, owner: str,
        collective_locals: Dict[str, Optional[str]],
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._function(child, owner)
            elif isinstance(child, ast.Assign) and len(child.targets) == 1 \
                    and isinstance(child.targets[0], ast.Name):
                self._assign(
                    child.targets[0].id, child.value, child, owner,
                    collective_locals,
                )
            elif isinstance(child, (ast.If, ast.Try, ast.With, ast.For,
                                    ast.While, ast.ExceptHandler)):
                self.walk_stmts(child, owner, collective_locals)

    def _assign(
        self, name: str, value: ast.AST, node: ast.AST, owner: str,
        collective_locals: Dict[str, Optional[str]],
    ) -> None:
        if not isinstance(value, ast.Call):
            return
        if _is_shard_map_call(value, self.imports):
            wrapped = value.args[0] if value.args else None
            collective_locals[name] = (
                wrapped.id if isinstance(wrapped, ast.Name) else None
            )
            return
        if _is_jit_call(value, self.imports):
            cfg = _jit_config(value)
            target_name: Optional[str] = None
            collective = False
            if value.args and isinstance(value.args[0], ast.Name):
                arg0 = value.args[0].id
                if arg0 in collective_locals:
                    collective = True
                    target_name = collective_locals[arg0]
                else:
                    target_name = arg0
            target = f"{owner}.{target_name}" if target_name else None
            self.inv.roots.append(JitRoot(
                name=name, owner=owner, module=self.mod.relpath,
                line=node.lineno, collective=collective,
                target=target, **cfg,
            ))

    def _function(self, node: ast.AST, owner: str) -> None:
        qual = f"{owner}.{node.name}"
        jit_deco = False
        collective = False
        cfg: Dict[str, Tuple] = {}
        for deco in node.decorator_list:
            eff = _unwrap_partial(deco, self.imports) or deco
            if isinstance(eff, ast.Call):
                if _is_jit_call(eff, self.imports):
                    jit_deco = True
                    cfg.update(_jit_config(eff))
                elif _is_shard_map_call(eff, self.imports):
                    collective = True
            else:
                resolved = resolve_dotted(eff, self.imports) or ""
                if resolved == "jax.jit" or resolved.endswith(".jit"):
                    jit_deco = True
        if jit_deco:
            self.inv.roots.append(JitRoot(
                name=node.name, owner=owner, module=self.mod.relpath,
                line=node.lineno, collective=collective, target=qual,
                **cfg,
            ))
        # a jit factory: builds a jax.jit program in its own body from
        # its parameters — each distinct argument tuple is a compile
        has_jit = any(
            isinstance(n, ast.Call) and _is_jit_call(n, self.imports)
            for n in _ordered_body(node)
        )
        params = tuple(
            a.arg for a in node.args.args if a.arg not in ("self", "cls")
        )
        if has_jit and params:
            self.inv.factories.append(JitFactory(
                name=node.name, qual=qual, module=self.mod.relpath,
                line=node.lineno, params=params,
            ))
        self.walk(node, qual)


# ------------------------------------------------- provenance lattice


def _is_const_name(name: str) -> bool:
    return name == name.upper() and any(c.isalpha() for c in name)


def _classify(
    expr: ast.AST, prov: Dict[str, int], imports: Dict[str, str],
) -> int:
    """Three-point shape-provenance lattice (docs/analysis.md §v5):
    CONST ⊑ BUCKETED ⊑ DYNAMIC; combinations take the max."""
    if isinstance(expr, ast.Constant):
        return _CONST
    if isinstance(expr, ast.Name):
        if expr.id in prov:
            return prov[expr.id]
        return _CONST if _is_const_name(expr.id) else _DYNAMIC
    if isinstance(expr, ast.Attribute):
        if expr.attr in _BUCKET_ATTRS:
            return _BUCKETED
        return _CONST if _is_const_name(expr.attr) else _DYNAMIC
    if isinstance(expr, ast.Call):
        term = _call_terminal(expr, imports)
        if term in _BUCKET_FNS:
            return _BUCKETED
        if term in ("max", "min") and expr.args:
            return max(_classify(a, prov, imports) for a in expr.args)
        return _DYNAMIC
    if isinstance(expr, ast.BinOp):
        return max(_classify(expr.left, prov, imports),
                   _classify(expr.right, prov, imports))
    if isinstance(expr, ast.UnaryOp):
        return _classify(expr.operand, prov, imports)
    if isinstance(expr, ast.IfExp):
        return max(_classify(expr.body, prov, imports),
                   _classify(expr.orelse, prov, imports))
    if isinstance(expr, (ast.Tuple, ast.List)) and expr.elts:
        return max(_classify(e, prov, imports) for e in expr.elts)
    return _DYNAMIC


def _track_assign(
    node: ast.AST, prov: Dict[str, int], imports: Dict[str, str],
) -> None:
    """Fold one statement into the provenance environment (last write
    wins — branch-insensitive, which is the right linter tradeoff)."""
    if isinstance(node, ast.Assign):
        val = _classify(node.value, prov, imports)
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                prov[tgt.id] = val
    elif isinstance(node, ast.AnnAssign) and node.value is not None \
            and isinstance(node.target, ast.Name):
        prov[node.target.id] = _classify(node.value, prov, imports)
    elif isinstance(node, ast.AugAssign) and isinstance(
            node.target, ast.Name):
        prov[node.target.id] = max(
            prov.get(node.target.id, _DYNAMIC),
            _classify(node.value, prov, imports),
        )
    elif isinstance(node, ast.For) and isinstance(node.target, ast.Name):
        # iterating a bucket ladder yields bucketed values
        prov[node.target.id] = _classify(node.iter, prov, imports)


# ----------------------------------------------------------- entry point


def jitflow_findings(
    audits: Sequence[ModuleAudit],
    graph: CallGraph,
    roots: Dict[str, ThreadRoot],
) -> List[Finding]:
    """Run all five v5 families over already-collected audits."""
    inv = build_inventory(audits)
    if not inv.roots and not inv.factories:
        return []
    caller_held = lockset.caller_held_locks(audits, graph, roots)
    findings: List[Finding] = []
    findings.extend(_retrace_and_donation_findings(audits, inv))
    findings.extend(_host_sync_findings(audits, graph, inv))
    findings.extend(_dispatch_findings(audits, inv, caller_held))
    findings.extend(_tracer_findings(audits, graph, inv))
    return sorted(set(findings))


# --------------------------------- family 1 + 4: retrace and donation


def _retrace_and_donation_findings(
    audits: Sequence[ModuleAudit], inv: Inventory,
) -> List[Finding]:
    out: List[Finding] = []
    names = {r.name for r in inv.roots} | {f.name for f in inv.factories}
    for audit in audits:
        mod = audit.module
        if not any(n in mod.source for n in names):
            continue
        retrace_exempt = _is_exempt(mod.relpath)
        for fn in audit.functions:
            if fn.node is None:  # the <module> pseudo record
                continue
            visible = inv.visible_roots(fn.qual, audit.dotted)
            prov: Dict[str, int] = {}
            #: donated name → (donating line, root name); killed on
            #: re-assignment
            donated: Dict[str, Tuple[int, str]] = {}
            for node in _ordered_body(fn.node):
                _track_assign(node, prov, audit.imports)
                if isinstance(node, ast.Name):
                    self_donate = donated.get(node.id)
                    if self_donate is not None:
                        if isinstance(node.ctx, ast.Store):
                            del donated[node.id]
                        elif isinstance(node.ctx, ast.Load) \
                                and node.lineno > self_donate[0]:
                            line, rname = self_donate
                            del donated[node.id]
                            if _suppressed(mod, DONATION_RULE,
                                           node.lineno):
                                continue
                            out.append(_finding(
                                mod, DONATION_RULE, node.lineno,
                                f"`{node.id}` was donated to jitted "
                                f"`{rname}` (line {line}, donate_"
                                "argnums) — its device buffer now "
                                "belongs to XLA and this read sees "
                                "freed memory; re-fetch the value from "
                                "the call's outputs or drop the "
                                "donation",
                            ))
                    continue
                if not isinstance(node, ast.Call):
                    continue
                resolved = resolve_dotted(node.func, audit.imports)
                bare = (
                    node.func.id if isinstance(node.func, ast.Name)
                    else None
                )
                if not retrace_exempt:
                    factory = inv.factory_for(bare, resolved, audit.dotted)
                    if factory is not None and factory.qual != fn.qual:
                        out.extend(_check_factory_call(
                            mod, fn, node, factory, prov, audit.imports,
                        ))
                root = visible.get(bare) if bare else None
                if root is None:
                    root = inv.root_by_qual(resolved)
                if root is None:
                    continue
                if not retrace_exempt:
                    out.extend(_check_static_args(
                        mod, fn, node, root, prov, audit.imports,
                    ))
                _record_donations(node, root, donated)
    return out


def _check_factory_call(
    mod: Module, fn: FnAudit, call: ast.Call, factory: JitFactory,
    prov: Dict[str, int], imports: Dict[str, str],
) -> List[Finding]:
    out: List[Finding] = []
    for i, arg in enumerate(call.args):
        if _classify(arg, prov, imports) != _DYNAMIC:
            continue
        if _suppressed(mod, RETRACE_RULE, call.lineno):
            continue
        pname = (
            factory.params[i] if i < len(factory.params) else f"#{i}"
        )
        out.append(_finding(
            mod, RETRACE_RULE, call.lineno,
            f"jit factory `{factory.name}` called with dynamic geometry "
            f"argument `{pname}` — every distinct value is a separate "
            "XLA compile (seconds in the tick path); derive it from the "
            "bucket ladder (bucket_nodes/bucket_pools, or the "
            "snapshot's `.bucket`)",
        ))
    return out


def _check_static_args(
    mod: Module, fn: FnAudit, call: ast.Call, root: JitRoot,
    prov: Dict[str, int], imports: Dict[str, str],
) -> List[Finding]:
    out: List[Finding] = []
    flagged: List[Tuple[int, str]] = []
    for kw in call.keywords:
        if kw.arg in root.static_argnames and \
                _classify(kw.value, prov, imports) == _DYNAMIC:
            flagged.append((call.lineno, kw.arg))
    for idx in root.static_argnums:
        if idx < len(call.args) and \
                _classify(call.args[idx], prov, imports) == _DYNAMIC:
            flagged.append((call.lineno, f"#{idx}"))
    for line, which in flagged:
        if _suppressed(mod, RETRACE_RULE, line):
            continue
        out.append(_finding(
            mod, RETRACE_RULE, line,
            f"jitted `{root.name}` called with dynamic value for static "
            f"argument `{which}` — each distinct value retraces and "
            "recompiles; feed a bucket-ladder value "
            "(bucket_nodes/bucket_pools) or a module constant",
        ))
    return out


def _record_donations(
    call: ast.Call, root: JitRoot, donated: Dict[str, Tuple[int, str]],
) -> None:
    for idx in root.donate_argnums:
        if idx < len(call.args) and isinstance(call.args[idx], ast.Name):
            donated[call.args[idx].id] = (call.lineno, root.name)
    for kw in call.keywords:
        if kw.arg in root.donate_argnames and isinstance(
                kw.value, ast.Name):
            donated[kw.value.id] = (call.lineno, root.name)


# ------------------------------------- family 2: host sync in hot path


def _hot_set(audits: Sequence[ModuleAudit], graph: CallGraph) -> Set[str]:
    """Quals on the reconcile/scan/tick paths: call-graph closure of the
    hot root names, widened with nested defs of hot functions (a jit
    factory's inner ``run`` executes inside its caller's scan even
    though the factory-result call ``_tick_fn(nb, pb)(...)`` has no
    nominal edge), iterated to fixpoint."""
    hot: Set[str] = {
        fn.qual
        for audit in audits
        for fn in audit.functions
        if fn.name in _HOT_ROOT_NAMES
        and audit.module.relpath.startswith("tpu_cc_manager_torch/")
        and not _is_exempt(audit.module.relpath)
    }
    all_quals = [
        fn.qual for audit in audits for fn in audit.functions
    ]
    while True:
        grown = graph.reachable(hot) | hot
        for q in all_quals:
            if q in grown:
                continue
            parent = q.rsplit(".", 1)[0]
            if parent in grown:
                grown.add(q)
        if grown == hot:
            return hot
        hot = grown


def _host_sync_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph, inv: Inventory,
) -> List[Finding]:
    hot = _hot_set(audits, graph)
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        for fn in audit.functions:
            if fn.qual not in hot or fn.node is None:
                continue
            visible = inv.visible_roots(fn.qual, audit.dotted)
            #: locals holding raw (device-side) jit outputs
            jit_out: Set[str] = set()
            for node in _ordered_body(fn.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    tgt = node.targets[0].id
                    if _is_jit_output(node.value, visible, jit_out,
                                      audit.imports, inv, audit.dotted):
                        jit_out.add(tgt)
                    else:
                        jit_out.discard(tgt)
                    continue
                if isinstance(node, ast.For) and \
                        _derived_from(node.iter, jit_out):
                    _emit_sync(out, mod, fn, node.lineno,
                               "iterating a jitted output")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                line = node.lineno
                func = node.func
                resolved = resolve_dotted(func, audit.imports) or ""
                if (isinstance(func, ast.Attribute)
                        and func.attr == "block_until_ready") or \
                        resolved == "jax.block_until_ready":
                    _emit_sync(out, mod, fn, line,
                               "`block_until_ready()` parks the thread "
                               "until the device finishes")
                    continue
                if isinstance(func, ast.Attribute) and \
                        func.attr == "item" and \
                        _derived_from(func.value, jit_out):
                    _emit_sync(out, mod, fn, line,
                               "`.item()` on a jitted output")
                    continue
                if isinstance(func, ast.Name) and \
                        func.id in ("float", "int", "bool", "list") and \
                        node.args and _derived_from(node.args[0], jit_out):
                    _emit_sync(out, mod, fn, line,
                               f"`{func.id}()` on a jitted output")
                    continue
                if resolved.startswith("numpy.") and \
                        resolved.rsplit(".", 1)[-1] in (
                            "asarray", "array") and \
                        node.args and _derived_from(node.args[0], jit_out):
                    _emit_sync(out, mod, fn, line,
                               "`np.asarray()` on a jitted output")
    return out


def _emit_sync(
    out: List[Finding], mod: Module, fn: FnAudit, line: int, what: str,
) -> None:
    if _suppressed(mod, SYNC_RULE, line):
        return
    out.append(_finding(
        mod, SYNC_RULE, line,
        f"{what} inside `{fn.name}`, which is on a reconcile/scan hot "
        "path — an implicit device→host sync stalls the controller "
        "thread on device completion; batch transfers through one "
        "explicit jax.device_get at the dispatch boundary",
    ))


def _is_jit_output(
    value: ast.AST, visible: Dict[str, JitRoot], jit_out: Set[str],
    imports: Dict[str, str], inv: Inventory, moddot: str,
) -> bool:
    """Whether an assigned RHS is a raw (device-side) jitted output.
    ``jax.device_get(...)`` results are host-side by definition; a jit
    FACTORY's result is the host-facing wrapper it returns, not a
    device value."""
    if isinstance(value, ast.Subscript):
        return _derived_from(value.value, jit_out)
    if not isinstance(value, ast.Call):
        return False
    func = value.func
    if isinstance(func, ast.Name):
        if func.id in visible:
            return True
        if func.id in jit_out:
            return False
    resolved = resolve_dotted(func, imports)
    root = inv.root_by_qual(resolved)
    return root is not None


def _derived_from(expr: ast.AST, jit_out: Set[str]) -> bool:
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    return isinstance(expr, ast.Name) and expr.id in jit_out


# ------------------------------------ family 3: unserialized dispatch


def _dispatch_findings(
    audits: Sequence[ModuleAudit], inv: Inventory,
    caller_held: Dict[str, FrozenSet[str]],
) -> List[Finding]:
    """Every call site of a collective (shard_map-wrapped) jitted
    callable must hold ``_DISPATCH_LOCK`` — lexically or on every
    resolved call path in (the caller-held ⋂-fixpoint)."""
    collective = [r for r in inv.roots if r.collective]
    if not collective:
        return []
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        for fn in audit.functions:
            visible = {
                name: root
                for name, root in inv.visible_roots(
                    fn.qual, audit.dotted).items()
                if root.collective
            }
            if not visible:
                continue
            inherited = caller_held.get(fn.qual, frozenset())
            for c in fn.calls:
                if c.bare is None or c.bare not in visible:
                    continue
                held = c.held_locks | inherited
                if any(
                    q.rsplit(".", 1)[-1] == _DISPATCH_LOCK_NAME
                    for q in held
                ):
                    continue
                if _suppressed(mod, DISPATCH_RULE, c.line):
                    continue
                out.append(_finding(
                    mod, DISPATCH_RULE, c.line,
                    f"collective jitted `{c.bare}` dispatched without "
                    f"holding {_DISPATCH_LOCK_NAME} (plan.py's dispatch "
                    "contract): XLA's cross-module all-reduce "
                    "rendezvous must not interleave from multiple host "
                    "threads — concurrent dispatch parks participants "
                    "in multi-second stalls; wrap the call in `with "
                    "plan._DISPATCH_LOCK:` or route through the "
                    "factory's locked runner",
                ))
    return out


# ----------------------------------------------- family 5: tracer leak


def _tracer_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph, inv: Inventory,
) -> List[Finding]:
    targets = {r.target for r in inv.roots if r.target}
    if not targets:
        return []
    #: static names per traced target (a condition on a static arg is
    #: Python-level: it re-traces, by design, rather than failing)
    static_of: Dict[str, Set[str]] = {}
    for r in inv.roots:
        if r.target:
            static_of.setdefault(r.target, set()).update(
                r.static_argnames)
    traced = graph.reachable(targets) | targets
    by_qual: Dict[str, Tuple[ModuleAudit, FnAudit]] = {
        fn.qual: (audit, fn)
        for audit in audits for fn in audit.functions
    }
    out: List[Finding] = []
    for qual in sorted(traced):
        hit = by_qual.get(qual)
        if hit is None:
            continue
        audit, fn = hit
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        for a in fn.accesses:
            if a.kind != "write" or a.init:
                continue
            if _suppressed(mod, TRACER_RULE, a.line):
                continue
            where = (
                f"module global `{a.key[1]}`" if a.key[0] == "global"
                else f"attribute `self.{a.key[-1]}`"
            )
            out.append(_finding(
                mod, TRACER_RULE, a.line,
                f"write to {where} inside `{fn.name}`, which runs under "
                "a jax trace: the statement executes once per "
                "(re)trace, not once per call — the stored value is a "
                "tracer or a stale trace-time constant; return it from "
                "the kernel instead",
            ))
        if qual in targets:
            out.extend(_tracer_condition_findings(
                mod, fn, static_of.get(qual, set())))
    return out


def _tracer_condition_findings(
    mod: Module, fn: FnAudit, static_names: Set[str],
) -> List[Finding]:
    """``if``/``while`` on a positional (traced-array) parameter inside
    a direct jit target: TracerBoolConversionError at trace time.
    Keyword-only parameters are config, not arrays; ``is (not) None``
    and ``isinstance`` are Python-level defaulting."""
    array_params = {
        p for p in fn.params if p not in ("self", "cls")
    } - static_names
    kwonly = {
        a.arg for a in getattr(fn.node.args, "kwonlyargs", [])
    }
    array_params -= kwonly
    if not array_params:
        return []
    out: List[Finding] = []
    for node in _ordered_body(fn.node):
        if not isinstance(node, (ast.If, ast.While)):
            continue
        test = node.test
        if _is_python_level_test(test):
            continue
        used = {
            n.id for n in ast.walk(test)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
        } & array_params
        if not used or _suppressed(mod, TRACER_RULE, node.lineno):
            continue
        name = sorted(used)[0]
        out.append(_finding(
            mod, TRACER_RULE, node.lineno,
            f"Python `{type(node).__name__.lower()}` on traced "
            f"parameter `{name}` inside jitted `{fn.name}` — a tracer "
            "has no truth value (TracerBoolConversionError); use "
            "jnp.where/lax.cond, or declare the argument static",
        ))
    return out


def _is_python_level_test(test: ast.AST) -> bool:
    if isinstance(test, ast.BoolOp):
        return all(_is_python_level_test(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_python_level_test(test.operand)
    if isinstance(test, ast.Compare):
        return all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        )
    if isinstance(test, ast.Call):
        term = test.func.attr if isinstance(test.func, ast.Attribute) \
            else test.func.id if isinstance(test.func, ast.Name) else None
        return term in ("isinstance", "callable", "hasattr")
    return False
