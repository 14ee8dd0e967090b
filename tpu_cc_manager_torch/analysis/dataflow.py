"""ccaudit dataflow core — flow-sensitive value tracking for the protocol
surface.

The lexical rules in ``rules.py`` ask "does this token appear here?";
the protocol rules need to ask "where did this *value* come from?". This
module is the reusable answer: a small abstract interpreter that walks
one function (or the module top level) in statement order, classifying
every expression into a SET of provable facts:

- ``CONST``      — provably from ``labels.py``/``modes.py`` (an imported
  constant, a ``Mode`` member, or ``Mode.X.value``);
- ``VALIDATED``  — the result of ``parse_mode(...)``/``Mode(...)``, i.e.
  a raw string that survived the protocol's one validation choke point;
- ``RAW``        — a raw protocol literal (``"on"``/``"off"``/
  ``"devtools"``/``"ici"``/``"failed"`` or a ``tpu.google.com/*``-shaped
  key) that did NOT come from the constants module;
- ``TAINTED``    — a desired/observed-mode label value read off a k8s
  object dict and not yet validated.

A value may carry several facts at once (``labels.get(K) or "off"`` is
TAINTED and RAW together; an if/else join unions the branches' facts),
and the empty set means "unknown" — the rules only fire on what they
can *prove*, so unknown always passes.

Tracking is bounded the same way the lockgraph's call summaries are
(lockgraph.py, callgraph.py): local assignments within one function,
plus **transitive interprocedural sink summaries over the whole-program
call graph** (v3) — a function whose parameter flows into a label-write
sink, directly or through any chain of resolvable calls (module
functions, ``self.``-methods, nested defs) up to the shared depth bound
(``callgraph.DEPTH_LIMIT``, ``--call-depth`` overrides), makes every
call with a RAW argument in that position a finding. Calls the graph
cannot resolve (attribute calls on unknown objects) fall back to the
old same-module terminal-name summary, so v2's coverage is a strict
floor. There is still no points-to analysis: unknown stays unknown and
passes.

Two rule families are built on the core:

``protocol-literal``
    A RAW value reaching a label/annotation write API
    (``set_cc_mode_state_label``, ``_set_state_label``,
    ``set_node_labels``/``set_node_annotations`` dict values, and
    transitive call-graph summaries thereof) must come from
    ``modes.py``/``labels.py``.

``unvalidated-mode``
    A mode-label value read off a k8s object dict (TAINTED) must pass
    through ``parse_mode``/``Mode(...)`` before reaching an engine /
    subprocess / device-call sink.

The next rule generation should target :class:`FunctionFlow` rather than
growing its own walker.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    FrozenSet,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from tpu_cc_manager_torch.analysis.core import (
    Finding,
    Module,
    collect_imports,
    dotted as _dotted,
    resolve_dotted,
)
from tpu_cc_manager_torch.analysis.rules import LABEL_PREFIX, _terminal_name
from tpu_cc_manager_torch.modes import STATE_FAILED, VALID_MODES

if TYPE_CHECKING:  # pragma: no cover - typing only
    from tpu_cc_manager_torch.analysis.callgraph import CallGraph
    from tpu_cc_manager_torch.analysis.rules import FnAudit, ModuleAudit

# -- the value lattice ------------------------------------------------------

CONST = "const"
VALIDATED = "validated"
RAW = "raw"
TAINTED = "tainted"

#: A classification is a SET of facts, not one point: the BoolOp
#: ``labels.get(K) or "off"`` is TAINTED *and* RAW at once, and both
#: rule families must see their half. The empty set is "unknown" —
#: nothing provable, so nothing fires.
Facts = FrozenSet[str]
NO_FACTS: Facts = frozenset()

#: Raw strings that ARE the mode/state protocol vocabulary — derived from
#: modes.py so a new Mode member widens the net automatically.
PROTOCOL_VALUES = frozenset(VALID_MODES) | {STATE_FAILED}

#: Dotted-module prefixes whose attributes classify as CONST. Both the
#: canonical absolute path and the bare module name are accepted so
#: fixtures (and hypothetical relative imports) resolve too.
_CONST_MODULE_PREFIXES = (
    "tpu_cc_manager_torch.labels.",
    "tpu_cc_manager_torch.modes.",
    "labels.",
    "modes.",
)

#: Callables that validate a raw string into a Mode (the protocol's one
#: choke point, modes.parse_mode).
_VALIDATORS = {
    "tpu_cc_manager_torch.modes.parse_mode",
    "tpu_cc_manager_torch.modes.Mode",
    "modes.parse_mode",
    "modes.Mode",
    "parse_mode",
    "Mode",
}

#: labels.py constants naming the desired/observed mode labels — reading
#: one of these off an object dict yields an unvalidated mode string.
_MODE_LABEL_CONSTS = ("CC_MODE_LABEL", "CC_MODE_STATE_LABEL")

# -- sinks ------------------------------------------------------------------

#: Label-write APIs taking the protocol VALUE as a scalar argument:
#: terminal call name -> (positional index, keyword name).
VALUE_SINKS: Dict[str, Tuple[int, str]] = {
    "set_cc_mode_state_label": (2, "value"),
    "_set_state_label": (0, "value"),
    "set_state_label": (0, "value"),
    "write_state_label": (0, "value"),
}

#: Label/annotation-write APIs taking a ``{key: value}`` dict:
#: terminal call name -> (positional index, keyword name).
DICT_SINKS: Dict[str, Tuple[int, str]] = {
    "set_node_labels": (1, "labels"),
    "set_node_annotations": (1, "ann"),
}

#: Where an unvalidated mode string must never arrive: the device layer
#: and anything that shells out. ``ModeEngine.set_mode`` is deliberately
#: NOT here — it calls ``parse_mode`` first thing, so handing it the raw
#: label value is the designed flow.
TAINT_SINK_TERMINALS = frozenset(
    {"set_cc_mode", "set_ici_mode", "apply_mode", "stage"}
)
TAINT_SINK_PREFIXES = ("subprocess.", "os.system", "os.popen")


#: the package-wide resolution fold, re-exported under the local idiom
_resolve = resolve_dotted


def _is_const_path(resolved: Optional[str]) -> bool:
    """True for ``labels.X`` / ``modes.X`` / ``Mode.ON`` / ``Mode.ON.value``."""
    if not resolved:
        return False
    path = resolved[:-len(".value")] if resolved.endswith(".value") else resolved
    if any(path.startswith(p) for p in _CONST_MODULE_PREFIXES):
        return True
    # `from tpu_cc_manager_torch.modes import Mode` -> "tpu_cc_manager_torch.modes.Mode.ON";
    # a bare un-imported `Mode.ON` (fixtures) still reads as the enum.
    return path.startswith("Mode.") or ".Mode." in path


@dataclass
class SinkSummary:
    """Summary of one function: which of its parameters flow into a
    protocol value sink — directly, or (v3) transitively through the
    call-graph fixpoint in :func:`collect_sink_summaries`."""

    name: str
    params: List[str]
    shifted: bool  #: first param is self/cls — attribute calls drop it
    sink_params: Set[str] = field(default_factory=set)
    qual: str = ""  #: call-graph qual ("" for module-local summaries)


@dataclass
class _ParamPass:
    """One caller-param-to-callee-arg handoff, the fixpoint's edge."""

    callee: str  #: resolved callee qual
    pos: int  #: positional index (-1 for keyword)
    kw: Optional[str]
    caller_param: str
    attr_call: bool  #: ``x.f(...)`` form — shifted summaries drop self


def _resolve_ast_call(
    graph: "CallGraph",
    audit: "ModuleAudit",
    fn: "FnAudit",
    call: ast.Call,
    imports: Dict[str, str],
) -> Optional[str]:
    """Resolve an AST call in ``fn``'s context to a graph qual."""
    func = call.func
    if isinstance(func, ast.Name):
        return graph.resolve_parts(
            audit.dotted, fn.cls, bare=func.id, scope=fn.scope,
            scope_kinds=fn.scope_kinds, fn_name=fn.name,
        )
    if isinstance(func, ast.Attribute):
        if (
            isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and fn.cls is not None
        ):
            return graph.resolve_parts(
                audit.dotted, fn.cls, attr_self=func.attr
            )
        resolved = resolve_dotted(func, imports)
        if resolved:
            return graph.resolve_parts(audit.dotted, fn.cls, dotted=resolved)
    return None


def _aligned_params(summary: SinkSummary, p: _ParamPass) -> List[str]:
    """Callee parameter names a pass lands on. Attribute calls on a
    shifted (method) summary are tried under BOTH alignments, same as
    the call-site check."""
    if p.kw is not None:
        return [p.kw] if p.kw in summary.params else []
    offsets = {0}
    if summary.shifted and p.attr_call:
        offsets.add(1)
    out = []
    for off in offsets:
        idx = p.pos + off
        if idx < len(summary.params):
            out.append(summary.params[idx])
    return out


def collect_sink_summaries(
    audits: Sequence["ModuleAudit"], graph: "CallGraph"
) -> Dict[str, SinkSummary]:
    """Whole-program sink summaries: a parameter is a sink param when it
    reaches a VALUE_SINK directly, or is handed to a sink param of any
    resolvable callee — iterated to a fixpoint bounded by the call-graph
    depth. Keys are call-graph quals."""
    summaries: Dict[str, SinkSummary] = {}
    passes: Dict[str, List[_ParamPass]] = {}
    for audit in audits:
        imports = audit.imports
        for fn in audit.functions:
            if fn.node is None:
                continue
            summary = SinkSummary(
                name=fn.name,
                params=list(fn.params),
                shifted=bool(fn.params) and fn.params[0] in ("self", "cls"),
                qual=fn.qual,
            )
            plist: List[_ParamPass] = []

            def on_call(
                call: ast.Call,
                flow: FunctionFlow,
                _audit: "ModuleAudit" = audit,
                _fn: "FnAudit" = fn,
                _imports: Dict[str, str] = imports,
                _summary: SinkSummary = summary,
                _plist: List[_ParamPass] = plist,
            ) -> None:
                term = _terminal_name(call.func)
                if term in VALUE_SINKS:
                    pos, kw = VALUE_SINKS[term]
                    arg = _call_arg(call, pos, kw)
                    if isinstance(arg, ast.Name) and arg.id in flow.params:
                        _summary.sink_params.add(arg.id)
                callee = _resolve_ast_call(graph, _audit, _fn, call, _imports)
                if callee is None:
                    return
                attr_call = isinstance(call.func, ast.Attribute)
                for i, a in enumerate(call.args):
                    if isinstance(a, ast.Name) and a.id in flow.params:
                        _plist.append(
                            _ParamPass(callee, i, None, a.id, attr_call)
                        )
                for k in call.keywords:
                    if (
                        k.arg is not None
                        and isinstance(k.value, ast.Name)
                        and k.value.id in flow.params
                    ):
                        _plist.append(
                            _ParamPass(callee, -1, k.arg, k.value.id,
                                       attr_call)
                        )

            flow = FunctionFlow(
                audit.module, imports, on_call, params=fn.params
            )
            flow.walk(getattr(fn.node, "body", []))
            summaries[fn.qual] = summary
            passes[fn.qual] = plist
    # propagate caller-param → callee-sink-param, depth-bounded fixpoint
    for _ in range(graph.depth):
        changed = False
        for qual, plist in passes.items():
            s = summaries[qual]
            for p in plist:
                callee = summaries.get(p.callee)
                if callee is None or not callee.sink_params:
                    continue
                for name in _aligned_params(callee, p):
                    if (
                        name in callee.sink_params
                        and p.caller_param not in s.sink_params
                    ):
                        s.sink_params.add(p.caller_param)
                        changed = True
        if not changed:
            break
    return {q: s for q, s in summaries.items() if s.sink_params}


def _call_arg(call: ast.Call, pos: int, kw: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    if len(call.args) > pos:
        return call.args[pos]
    return None


class FunctionFlow:
    """Statement-order abstract interpreter over one scope.

    ``env`` maps local names to FACT SETS. ``if``/``else`` branches are
    walked against independent snapshots and JOINED afterwards by set
    union, so a name that is RAW on one path and CONST on the other
    keeps BOTH facts — one clean branch can never launder a dirty one,
    and a ``tainted or "default"`` fallback stays simultaneously TAINTED
    and RAW. Loop/try bodies are walked in document order against the
    running environment (conservative enough: a loop body's RAW stays
    RAW after the loop).
    """

    def __init__(
        self,
        module: Module,
        imports: Dict[str, str],
        on_call: Callable[[ast.Call, "FunctionFlow"], None],
        params: Sequence[str] = (),
    ):
        self.module = module
        self.imports = imports
        self.on_call = on_call
        self.env: Dict[str, Facts] = {}
        self.params = set(params)

    # ------------------------------------------------------------ classify
    def classify(self, expr: ast.AST) -> Facts:
        """The set of facts provable about ``expr``'s value. A value can
        carry SEVERAL facts at once — ``labels.get(K) or "off"`` is both
        TAINTED (the read side) and RAW (the fallback side), and must
        trip both rule families."""
        if isinstance(expr, ast.Constant):
            if isinstance(expr.value, str) and (
                expr.value in PROTOCOL_VALUES or LABEL_PREFIX in expr.value
            ):
                return frozenset((RAW,))
            return NO_FACTS
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id, NO_FACTS)
        if isinstance(expr, ast.Attribute):
            resolved = _resolve(expr, self.imports)
            if _is_const_path(resolved):
                return frozenset((CONST,))
            # `m.value` where m is a local known to be CONST/VALIDATED
            if expr.attr == "value" and isinstance(expr.value, ast.Name):
                facts = self.env.get(expr.value.id, NO_FACTS)
                if facts and facts <= {CONST, VALIDATED}:
                    return frozenset((CONST,))
            return NO_FACTS
        if isinstance(expr, ast.Call):
            resolved = _resolve(expr.func, self.imports)
            if resolved in _VALIDATORS:
                return frozenset((VALIDATED,))
            if self._is_mode_label_get(expr):
                return frozenset((TAINTED,))
            return NO_FACTS
        if isinstance(expr, ast.Subscript):
            if self._is_mode_label_key(expr.slice):
                return frozenset((TAINTED,))
            return NO_FACTS
        if isinstance(expr, (ast.BoolOp,)):
            return self._join(expr.values)
        if isinstance(expr, ast.IfExp):
            return self._join([expr.body, expr.orelse])
        return NO_FACTS

    def _join(self, exprs: Sequence[ast.AST]) -> Facts:
        out: Facts = NO_FACTS
        for e in exprs:
            out = out | self.classify(e)
        return out

    def _is_mode_label_key(self, key: ast.AST) -> bool:
        resolved = _resolve(key, self.imports)
        if not resolved:
            return False
        return resolved.rsplit(".", 1)[-1] in _MODE_LABEL_CONSTS and (
            _is_const_path(resolved) or resolved in _MODE_LABEL_CONSTS
        )

    def _is_mode_label_get(self, call: ast.Call) -> bool:
        """``<obj>.get(CC_MODE_LABEL[, default])`` — the canonical k8s
        label read."""
        return (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "get"
            and bool(call.args)
            and self._is_mode_label_key(call.args[0])
        )

    # ---------------------------------------------------------------- walk
    def walk(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return  # nested scopes are separate flows
        if isinstance(stmt, ast.If):
            self._calls_in(stmt.test)
            base_env, base_params = dict(self.env), set(self.params)
            self.walk(stmt.body)
            body_env, body_params = self.env, self.params
            self.env, self.params = dict(base_env), set(base_params)
            if stmt.orelse:
                self.walk(stmt.orelse)
            self.env = self._join_envs(body_env, self.env)
            self.params = body_params & self.params
            return
        if isinstance(stmt, ast.Assign):
            self._calls_in(stmt.value)
            cls = self.classify(stmt.value)
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    self.env[tgt.id] = cls
                    self.params.discard(tgt.id)
                else:
                    # tuple/starred/subscript targets: conservatively
                    # invalidate every name the target REBINDS (Store
                    # ctx), so `mode, ok = validate(mode), True` can't
                    # leave a stale RAW/TAINTED classification behind
                    self._invalidate(tgt)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._calls_in(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = self.classify(stmt.value)
                self.params.discard(stmt.target.id)
            else:
                self._invalidate(stmt.target)
            return
        if isinstance(stmt, ast.AugAssign):
            self._calls_in(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = NO_FACTS
            return
        # expressions hanging off the statement head (test, iter, with
        # items, return/expr values) are visited first, then every nested
        # body in document order
        self._head_exprs(stmt)
        if isinstance(stmt, ast.For):
            for node in ast.walk(stmt.target):
                if isinstance(node, ast.Name):
                    self.env[node.id] = NO_FACTS
        for item in getattr(stmt, "items", []):
            if item.optional_vars is not None:
                for node in ast.walk(item.optional_vars):
                    if isinstance(node, ast.Name):
                        self.env[node.id] = NO_FACTS
        for f in ("body", "orelse"):
            sub = getattr(stmt, f, None)
            if sub and isinstance(sub, list):
                self.walk(sub)
        for handler in getattr(stmt, "handlers", []):
            self.walk(handler.body)
        for case in getattr(stmt, "cases", []):
            self.walk(case.body)
        sub = getattr(stmt, "finalbody", None)
        if sub:
            self.walk(sub)

    @staticmethod
    def _join_envs(a: Dict[str, Facts], b: Dict[str, Facts]) -> Dict[str, Facts]:
        out: Dict[str, Facts] = {}
        for name in set(a) | set(b):
            out[name] = a.get(name, NO_FACTS) | b.get(name, NO_FACTS)
        return out

    def _invalidate(self, target: ast.AST) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                self.env[node.id] = NO_FACTS
                self.params.discard(node.id)

    def _head_exprs(self, stmt: ast.stmt) -> None:
        for f in ("value", "test", "iter", "exc", "subject"):
            sub = getattr(stmt, f, None)
            if isinstance(sub, ast.AST):
                self._calls_in(sub)
        for item in getattr(stmt, "items", []):
            self._calls_in(item.context_expr)

    def _calls_in(self, expr: ast.AST) -> None:
        """Visit every Call in an expression tree (outer first), skipping
        nested lambda/comprehension scopes is deliberately NOT done — a
        sink call inside a lambda still writes the label."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self.on_call(node, self)


# ----------------------------------------------------------- rule driving


class _ProtocolAuditor:
    """Runs both dataflow rule families over one module."""

    def __init__(
        self,
        module: Module,
        audit: Optional["ModuleAudit"] = None,
        graph: Optional["CallGraph"] = None,
        global_summaries: Optional[Dict[str, SinkSummary]] = None,
    ):
        self.module = module
        self.imports = collect_imports(module.tree)
        self.findings: Set[Finding] = set()
        self.summaries: Dict[str, SinkSummary] = {}
        self.audit = audit
        self.graph = graph
        self.global_summaries = global_summaries or {}
        #: resolution context while walking one function (v3)
        self._current_fn: Optional["FnAudit"] = None

    # ------------------------------------------------------------ plumbing
    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        if self.module.suppressed(rule, line):
            return
        self.findings.add(
            Finding(
                file=self.module.relpath,
                line=line,
                rule=rule,
                message=message,
                text=self.module.line_text(line),
            )
        )

    def _sink_arg(
        self, call: ast.Call, pos: int, kw: str
    ) -> Optional[ast.AST]:
        for k in call.keywords:
            if k.arg == kw:
                return k.value
        if len(call.args) > pos:
            return call.args[pos]
        return None

    # ------------------------------------------------------ phase 1: summaries
    def collect_summaries(self) -> None:
        """Which params of each module function reach a value sink
        DIRECTLY — the same-module terminal-name fallback for calls the
        whole-program graph cannot resolve (the transitive summaries
        live in :func:`collect_sink_summaries`)."""
        for node in ast.walk(self.module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in node.args.args]
            shifted = bool(params) and params[0] in ("self", "cls")
            summary = SinkSummary(node.name, params, shifted)

            def on_call(
                call: ast.Call,
                flow: FunctionFlow,
                s: SinkSummary = summary,
            ) -> None:
                term = _terminal_name(call.func)
                if term not in VALUE_SINKS:
                    return
                arg = self._sink_arg(call, *VALUE_SINKS[term])
                if (
                    isinstance(arg, ast.Name)
                    and arg.id in flow.params
                ):
                    s.sink_params.add(arg.id)

            flow = FunctionFlow(
                self.module, self.imports, on_call, params=params
            )
            flow.walk(node.body)
            if summary.sink_params:
                # latest definition wins, same as runtime rebinding
                self.summaries[node.name] = summary

    # ------------------------------------------------------- phase 2: rules
    def run(self) -> List[Finding]:
        self.collect_summaries()
        if self.audit is not None:
            self._current_fn = self.audit.functions[0]  # <module> record
        flow = FunctionFlow(self.module, self.imports, self._on_call)
        flow.walk(self.module.tree.body)
        if self.audit is not None and self.graph is not None:
            for fn in self.audit.functions:
                if fn.node is None:
                    continue
                self._current_fn = fn
                fn_flow = FunctionFlow(
                    self.module, self.imports, self._on_call,
                    params=fn.params,
                )
                fn_flow.walk(getattr(fn.node, "body", []))
        else:
            for node in ast.walk(self.module.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn_flow = FunctionFlow(
                        self.module, self.imports, self._on_call,
                        params=[a.arg for a in node.args.args],
                    )
                    fn_flow.walk(node.body)
        return sorted(self.findings)

    def _on_call(self, call: ast.Call, flow: FunctionFlow) -> None:
        term = _terminal_name(call.func)
        if term in VALUE_SINKS:
            arg = self._sink_arg(call, *VALUE_SINKS[term])
            if arg is not None:
                self._check_value(arg, flow, term)
        if term in DICT_SINKS:
            arg = self._sink_arg(call, *DICT_SINKS[term])
            if isinstance(arg, ast.Dict):
                for key, value in zip(arg.keys, arg.values):
                    if value is not None:
                        self._check_value(value, flow, term)
                    # raw literal keys are already label-literal findings;
                    # a key *flowed* through a local is caught here
                    if (
                        key is not None
                        and not isinstance(key, (ast.Constant, ast.JoinedStr))
                        and RAW in flow.classify(key)
                    ):
                        self._add(
                            "protocol-literal", key,
                            f"label key reaching {term}() carries a raw "
                            "protocol literal — use the labels.py constant",
                        )
        self._check_taint_sink(call, flow, term)
        self._check_summary_call(call, flow, term)

    def _check_value(
        self, arg: ast.AST, flow: FunctionFlow, sink: str
    ) -> None:
        if RAW in flow.classify(arg):
            display = (
                repr(arg.value) if isinstance(arg, ast.Constant)
                else (_dotted(arg) or "value")
            )
            self._add(
                "protocol-literal", arg,
                f"raw protocol literal {display} flows into {sink}() — "
                "the cluster-visible vocabulary lives in modes.py/"
                "labels.py (e.g. Mode.ON.value, STATE_FAILED); import "
                "the constant",
            )

    def _check_taint_sink(
        self, call: ast.Call, flow: FunctionFlow, term: Optional[str]
    ) -> None:
        resolved = _resolve(call.func, self.imports) or ""
        is_sink = term in TAINT_SINK_TERMINALS or any(
            resolved == p or resolved.startswith(p)
            for p in TAINT_SINK_PREFIXES
        )
        if not is_sink:
            return
        for top in list(call.args) + [k.value for k in call.keywords]:
            # walk into containers: `subprocess.run([exe, mode])` taints
            # through the argv list
            tainted = next(
                (
                    sub for sub in ast.walk(top)
                    if TAINTED in flow.classify(sub)
                ),
                None,
            )
            if tainted is not None:
                arg = tainted
                self._add(
                    "unvalidated-mode", arg,
                    f"mode label value reaches {term or resolved}() without "
                    "parse_mode() — a mistyped or hostile label value must "
                    "die at the validation choke point, not inside the "
                    "device layer or a subprocess argv",
                )

    def _check_summary_call(
        self, call: ast.Call, flow: FunctionFlow, term: Optional[str]
    ) -> None:
        if term in VALUE_SINKS:
            return
        # v3: the whole-program summary first (transitive, cross-module);
        # the same-module terminal-name map remains the fallback for
        # calls the graph cannot resolve (unknown receivers)
        summary: Optional[SinkSummary] = None
        if (
            self.graph is not None
            and self.audit is not None
            and self._current_fn is not None
        ):
            qual = _resolve_ast_call(
                self.graph, self.audit, self._current_fn, call, self.imports
            )
            if qual is not None:
                summary = self.global_summaries.get(qual)
        if summary is None:
            summary = self.summaries.get(term or "")
        if summary is None:
            return
        # map call-site args back to parameter names. A shifted
        # (method) summary is tried under BOTH
        # alignments — `self.publish(x)` drops self at the call site,
        # `Cls.publish(obj, x)` passes it explicitly; a raw literal that
        # only lines up under the wrong alignment is still a raw mode
        # string handed to a label-writing helper, worth a look (pragma
        # the rare deliberate case)
        offsets = {0}
        if summary.shifted and isinstance(call.func, ast.Attribute):
            offsets.add(1)
        for i, arg in enumerate(call.args):
            for offset in offsets:
                idx = i + offset
                if idx < len(summary.params) and (
                    summary.params[idx] in summary.sink_params
                ):
                    if RAW in flow.classify(arg):
                        self._add(
                            "protocol-literal", arg,
                            f"raw protocol literal passed to {term}(), "
                            f"whose parameter {summary.params[idx]!r} "
                            "flows into a label write — import the "
                            "modes.py/labels.py constant",
                        )
        for k in call.keywords:
            if k.arg in summary.sink_params and RAW in flow.classify(k.value):
                self._add(
                    "protocol-literal", k.value,
                    f"raw protocol literal passed to {term}(), whose "
                    f"parameter {k.arg!r} flows into a label write — "
                    "import the modes.py/labels.py constant",
                )


def protocol_findings(
    module: Module,
    audit: Optional["ModuleAudit"] = None,
    graph: Optional["CallGraph"] = None,
    summaries: Optional[Dict[str, SinkSummary]] = None,
) -> List[Finding]:
    """Run the protocol-literal and unvalidated-mode rule families over
    one module (the per-module entry analyze_modules drives). With
    ``audit``/``graph``/``summaries`` the call-site check consults the
    whole-program transitive sink summaries; without them it falls back
    to the v2 same-module behavior (unit-test seam)."""
    return _ProtocolAuditor(module, audit, graph, summaries).run()
