"""ccaudit rules: one AST walk per module, plus the global metric pass.

``audit_module`` produces per-module findings (raw-acquire,
blocking-under-lock, label-literal, swallow) and the raw material the
cross-module passes consume: lexical lock-order edges plus per-function
records (``FnAudit``) — entry locks, call sites with their held lock,
blocking sites, thread/callback references, and shared-state accesses —
from which ``callgraph.py`` builds the whole-program call graph and
``threads.py``/``lockset.py`` run the v3 concurrency passes.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from tpu_cc_manager_torch.analysis.core import (
    Finding,
    Module,
    collect_imports,
    dotted as _dotted,
    module_dotted,
    resolve_dotted,
)
from tpu_cc_manager_torch.modes import Mode as _Mode

# -- mode exhaustiveness ----------------------------------------------------

#: Derived from the live enum so adding a Mode member instantly fails
#: every dispatch that doesn't handle it.
_MODE_MEMBERS = frozenset(_Mode.__members__)

# -- lock identification ----------------------------------------------------

#: A name reads as a lock when its terminal component says so. This is the
#: project's actual naming convention (``self._lock``, ``_stop_lock``,
#: ``self._cond``); locks assigned from ``threading.Lock()`` under any
#: other name are caught by the known-lock assignment tracker.
_LOCKY_NAME = re.compile(
    r"(?:^|_)(?:lock|rlock|cond|condition|mutex|sem|semaphore)s?$", re.I
)

_THREADING_LOCK_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"
}

#: Reentrant lock types: a self-edge in the order graph (the same lock
#: taken while already held) is legal for these, a deadlock for Lock.
_REENTRANT_CTORS = {"RLock", "Condition"}

#: asyncio synchronization ctors (v4): same ordering/blocking shape as
#: thread locks, but they exclude COROUTINES, not threads — the v4
#: asyncflow pass needs the two identities kept apart (an asyncio.Lock
#: is a valid guard across an await; it guards nothing across threads).
_ASYNCIO_LOCK_CTORS = {
    "Lock", "Semaphore", "BoundedSemaphore", "Condition"
}

# -- blocking-call identification -------------------------------------------

#: Dotted-path prefixes that block on I/O or the clock. Matching is done
#: on the *resolved* path (import aliases folded in), so ``from time
#: import sleep`` and ``import subprocess as sp`` are both seen through.
#: ``concurrent.futures.*`` joined for the flip-executor pattern: module-
#: level waits (``futures.wait``, ``as_completed``) block on OTHER
#: threads' progress — under a lock those threads may need, that is a
#: deadlock, not a convoy.
_BLOCKING_PREFIXES = (
    "time.sleep",
    "subprocess.",
    "socket.",
    "urllib.",
    "requests.",
    "http.client.",
    "select.",
    "concurrent.futures.",
)

#: Method names that wait on an executor/future regardless of how the
#: receiver was imported (``fut.result()`` has no resolvable module
#: path). ``result`` is deliberately the only entry: ``shutdown`` and
#: ``wait`` collide with this project's agent/server vocabulary, and a
#: future's ``exception()`` never appears outside test code here.
_EXECUTOR_WAIT_METHODS = frozenset({"result"})

# -- label hygiene ----------------------------------------------------------

#: Built by concatenation so this module's own source doesn't trip the
#: rule it implements.
LABEL_PREFIX = "tpu.google" + ".com/"

#: Files allowed to hold protocol literals: labels.py is the single
#: source of truth; the analysis package needs the prefix to check for it.
_LABEL_EXEMPT_BASENAMES = {"labels.py"}
_LABEL_EXEMPT_DIRS = ("tpu_cc_manager_torch/analysis/",)

# -- exception discipline ---------------------------------------------------

_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "fatal", "log",
}

# -- metric names -----------------------------------------------------------

_METRIC_CTORS = {"Counter", "Gauge", "Histogram", "HistogramVec"}
_METRIC_NAME_RE = re.compile(r"^tpu_cc_[a-z0-9_]+$")
_METRIC_SUFFIXES = ("_bucket", "_sum", "_count")

#: Strings the metric regex matches that aren't metric names.
_METRIC_IGNORE = {"tpu_cc_manager", "tpu_cc_manager_torch"}


@dataclass
class LockSite:
    """One ``with <lock>:`` acquisition."""

    qual: str  #: graph node id, e.g. ``agent.Agent._event_lock``
    display: str  #: what the developer wrote, e.g. ``self._event_lock``
    file: str
    line: int
    text: str
    reentrant: bool = False
    #: lock identity (v4): "thread" (threading.* ctor seen), "async"
    #: (asyncio.* ctor seen), or "unknown" (name-matched only). The
    #: asyncflow pass treats only "async" quals as await-safe guards
    #: and only "thread" quals as loop-blocking when held at an await.
    kind: str = "unknown"


@dataclass
class BlockSite:
    """One call that blocks on I/O, the clock, or another thread."""

    what: str  #: display, e.g. ``time.sleep`` or ``fut.result()``
    file: str
    line: int
    text: str
    #: a ``blocking-under-lock`` pragma on the site sanctions it — the
    #: transitive pass must not re-report a deliberately blessed wait
    suppressed: bool


@dataclass
class ArgRef:
    """A function-reference-shaped argument at a call site — the raw
    material for parameter-callback linking (callgraph.py): if the
    callee ever *calls* the parameter this lands on, the callback runs
    in the calling site's thread context."""

    pos: "int | str"  #: positional index or keyword name
    attr_self: Optional[str]
    cls: Optional[str]
    bare: Optional[str]
    dotted: Optional[str]


@dataclass
class CallRecord:
    """One call site, with everything the resolver needs."""

    #: method name when the call is ``self.m(...)`` (or on a ``self``
    #: alias like the webhook's ``outer``)
    attr_self: Optional[str]
    #: class the ``self``/alias receiver belongs to (aliases may point
    #: at an ENCLOSING class, not the caller's own)
    cls: Optional[str]
    #: bare ``name(...)`` — resolved against nested defs, then the module
    bare: Optional[str]
    #: import-folded dotted path (``tpu_cc_manager_torch.modes.parse_mode``)
    resolved: Optional[str]
    #: terminal name (legacy same-module summary fallback in dataflow)
    term: Optional[str]
    #: full dotted candidate when the receiver is a typed local
    #: (``fleet = FleetController(...)``; ``fleet.run()`` →
    #: ``tpu_cc_manager_torch.fleet.FleetController.run``)
    recv_class: Optional[str]
    line: int
    #: innermost lock held lexically at the call site, if any
    held: Optional[LockSite]
    #: quals of EVERY lock held lexically at the site — the lockset
    #: pass propagates these into the callee (the ``_locked``-suffix
    #: convention: the guard lives at the caller)
    held_locks: FrozenSet[str] = frozenset()
    #: reference-shaped args (incl. values inside dict/list/tuple
    #: literal args) for parameter-callback linking
    arg_refs: List[ArgRef] = field(default_factory=list)


@dataclass
class RefSite:
    """A function *reference* escaping into thread-spawn machinery: a
    ``threading.Thread(target=…)`` or an executor ``submit`` callable.
    (Callbacks handed to other components are NOT RefSites — they get
    call-graph edges via ``ArgRef`` + parameter-callback linking.)"""

    kind: str  #: "thread" | "submit"
    attr_self: Optional[str]
    #: class the ``self``/alias receiver belongs to (for ``attr_self``)
    cls: Optional[str]
    bare: Optional[str]
    resolved: Optional[str]
    #: full dotted candidate built from a typed local receiver
    #: (``tpu_cc_manager_torch.fleet.FleetController.run``)
    recv_class: Optional[str]
    line: int
    #: spawned in a loop / executor / per-request handler — the root is
    #: concurrent with ITSELF, so one context is already a race surface
    self_concurrent: bool


@dataclass
class AccessSite:
    """One read/write of shared-shaped state: a ``self.``-attribute or a
    mutable module global."""

    key: Tuple[str, ...]  #: ("attr", Class, name) | ("global", name)
    kind: str  #: "read" | "write"
    locks: FrozenSet[str]  #: quals of locks held lexically at the site
    #: happens-before everything: ``__init__`` / module top level
    init: bool
    fn_qual: str
    file: str
    line: int
    text: str
    suppressed: bool  #: ``race-lockset`` pragma on the site
    #: write lexically before the first ``.start()`` in a function that
    #: spawns a thread — happens-before the SPAWNED thread, but NOT
    #: before concurrent invocations of the spawning function itself
    #: (lockset.py only honors this when the function's own context is
    #: a single non-self-concurrent one)
    prespawn: bool = False


@dataclass
class AwaitSite:
    """One suspension point inside an ``async def`` (v4): a lexical
    ``await``, or the implicit awaits of ``async for`` / ``async with``
    entry. Every other coroutine on the loop may run here — the
    interleaving point the await-atomicity lattice is built around."""

    line: int
    text: str
    #: quals of every lock held lexically at the suspension point
    locks: FrozenSet[str]
    #: the subset of held locks with confirmed *threading* identity —
    #: holding one across an await parks the whole event loop behind
    #: whatever thread owns it (the lock-across-await rule's material)
    thread_locks: Tuple[LockSite, ...] = ()


@dataclass
class FnAudit:
    """Everything one function/method contributes to the call graph and
    the thread/lockset passes."""

    name: str
    qual: str  #: ``<module dotted>.<scopes…>.<name>``
    #: enclosing scope names above this function (classes and functions)
    scope: Tuple[str, ...]
    #: parallel kinds ("class"/"fn") — bare-name resolution only looks
    #: through *function* scopes (Python scoping skips class bodies)
    scope_kinds: Tuple[str, ...]
    #: innermost enclosing class name (None for plain functions)
    cls: Optional[str]
    #: scope prefix up to and including the innermost class — the key
    #: ``self.m()`` resolution uses, so nested classes stay distinct
    class_path: Optional[Tuple[str, ...]]
    params: List[str]
    line: int
    #: the def's AST node (None only for the ``<module>`` pseudo record)
    #: — dataflow.py re-walks it for the global sink-summary fixpoint
    node: Optional[ast.AST] = None
    #: locks acquired while holding nothing — the transitive summary's
    #: raw material (locks nested under others produce lexical edges)
    entry_locks: List[LockSite] = field(default_factory=list)
    calls: List[CallRecord] = field(default_factory=list)
    blocking: List[BlockSite] = field(default_factory=list)
    refs: List[RefSite] = field(default_factory=list)
    accesses: List[AccessSite] = field(default_factory=list)
    #: parameters stored into ``self`` attributes (``self.A = p``,
    #: ``self.A[k] = p``, ``self.A.put(p)/append(p)/add(p)``) — the
    #: other half of parameter-callback linking
    param_attr_stores: List[Tuple[str, str]] = field(default_factory=list)
    #: ``do_*`` method of a ``*RequestHandler`` subclass — runs on a
    #: per-request thread of a ThreadingHTTPServer
    handler_root: bool = False
    #: ``async def`` (v4) — the body runs as a coroutine on the event
    #: loop; the asyncflow pass keys its whole analysis off this
    is_async: bool = False
    #: suspension points in source order (empty for sync functions)
    awaits: List[AwaitSite] = field(default_factory=list)


@dataclass
class ModuleAudit:
    """Everything one module contributes to the global passes."""

    module: Module
    #: importable dotted path (``tpu_cc_manager_torch.device.fake``)
    dotted: str = ""
    findings: List[Finding] = field(default_factory=list)
    #: lock-order edges: (outer LockSite, inner LockSite) — inner was
    #: acquired lexically while outer was held
    lock_edges: List[Tuple[LockSite, LockSite]] = field(default_factory=list)
    #: per-function records, including the ``<module>`` top-level pseudo
    #: record (index 0) for import-time thread spawns
    functions: List[FnAudit] = field(default_factory=list)
    #: metric declarations: name -> [(file, line, text)]
    metric_decls: Dict[str, List[Tuple[str, int, str]]] = field(
        default_factory=dict
    )
    #: tpu_cc_* string literals used outside a declaration
    metric_uses: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: watchdog WatchSeries(metric=...) declarations: (metric, line,
    #: text) — every watched series must reference a declared metric
    #: (ISSUE 15: an anomaly detector over a metric nobody renders can
    #: never fire), checked cross-module like metric_uses but WITHOUT
    #: the tpu_cc_ prefix gate: a watchdog typo outside the prefix
    #: must not escape the liveness check
    watch_series_refs: List[Tuple[str, int, str]] = field(
        default_factory=list
    )
    #: labels.py constant references: (constant name, use context) where
    #: context is "read" (.get/subscript/compare), "write" (dict key) or
    #: "other" — raw material for the protocol-liveness pass
    label_uses: List[Tuple[str, str]] = field(default_factory=list)
    #: lock quals acquired in this module whose ctor was asyncio.* (v4)
    #: — the race pass discounts these as cross-THREAD guards, and the
    #: await-atomicity pass accepts only these as cross-AWAIT guards
    async_lock_quals: Set[str] = field(default_factory=set)
    #: the module's import fold (core.collect_imports), computed once by
    #: the walker and shared — the asyncflow/dataflow passes re-resolve
    #: names per module and must not re-walk the tree to do it
    imports: Dict[str, str] = field(default_factory=dict)

    def add(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        if self.module.suppressed(rule, line):
            return
        self.findings.append(
            Finding(
                file=self.module.relpath,
                line=line,
                rule=rule,
                message=message,
                text=self.module.line_text(line),
            )
        )


def _terminal_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _collect_docstring_nodes(tree: ast.Module) -> Set[int]:
    """id()s of Constant nodes that are docstrings — string literals, but
    not protocol data."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


#: Attribute method names that mutate their receiver in place — a call
#: like ``self.chips.append(x)`` is a WRITE to ``chips``. Queue verbs
#: (put/get) are deliberately absent: queue.Queue is internally locked.
#: ``update``/``clear``/``set`` are absent too — they collide with this
#: project's method vocabulary (``metrics.update``) and with
#: ``threading.Event`` (internally locked), and would swamp the signal.
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "extend", "insert",
    "remove", "discard", "setdefault", "pop", "popitem",
    "popleft", "sort",
})

#: Ctors whose result is shared-mutable module state when assigned at
#: module top level (the race pass's module-global domain).
_MUTABLE_GLOBAL_CTORS = frozenset({
    "set", "dict", "list", "deque", "defaultdict", "Counter",
    "OrderedDict",
})

#: container store/fetch verbs for parameter-callback linking through a
#: queue/deque attribute (`self._q.put(task)` … `task = self._q.get()`)
_CONTAINER_STORE_METHODS = frozenset({
    "put", "put_nowait", "append", "appendleft", "add",
})
_CONTAINER_GET_METHODS = frozenset({"get", "get_nowait", "pop", "popleft"})


class _Walker(ast.NodeVisitor):
    def __init__(self, audit: ModuleAudit):
        self.audit = audit
        self.module = audit.module
        modname = self.module.relpath.rsplit("/", 1)[-1]
        self.modbase = modname[:-3] if modname.endswith(".py") else modname
        self.dotted_mod = module_dotted(self.module.relpath)
        audit.dotted = self.dotted_mod
        self.docstrings = _collect_docstring_nodes(self.module.tree)
        #: Constant nodes that are a metric declaration's name argument
        self._decl_nodes: Set[int] = set()
        #: local names known to be locks via `x = threading.Lock()` style
        #: assignment, keyed by terminal name; value: reentrant?
        self.known_locks: Dict[str, bool] = {}
        #: the subset whose ctor was asyncio.* (v4 lock identity)
        self.known_async_locks: Set[str] = set()
        #: import alias -> real dotted prefix, pre-collected with the
        #: package-shared fold (core.collect_imports)
        self.imports: Dict[str, str] = collect_imports(self.module.tree)
        self.class_stack: List[str] = []
        self.func_stack: List[str] = []
        self.lock_stack: List[LockSite] = []
        #: functions with try/finally releasing lock X (terminal names)
        self._finally_released: Set[str] = set()
        #: If nodes already consumed as an elif of an analyzed chain
        self._elif_seen: Set[int] = set()
        self.label_exempt = self._label_exempt(self.module.relpath)
        # ---- v3 collection state -------------------------------------
        #: full scope chain of (kind, name) above the current node
        self.scope_stack: List[Tuple[str, str]] = []
        #: ``x = self`` closure aliases (webhook's ``outer``): name →
        #: class the aliased self belongs to; inherited by nested scopes
        self.self_aliases: Dict[str, str] = {}
        #: ``x = SomeClass(...)`` typed locals: name → ctor dotted path
        self.var_types: Dict[str, str] = {}
        #: base-class terminal names per class scope qual
        self._class_bases: Dict[Tuple[str, ...], List[str]] = {}
        self.loop_depth = 0
        #: Attribute nodes that are a call's func (method access, not a
        #: state read) — visit_Call marks them before children are walked
        self._call_func_attrs: Set[int] = set()
        #: receiver nodes of in-place mutator calls / subscript stores —
        #: recorded as writes instead of reads
        self._mutated_receivers: Set[int] = set()
        #: local var → self-attr it was fetched from (`x = self._q.get()`)
        self._attr_origin: Dict[str, str] = {}
        #: names the current function binds locally (no `global` decl) —
        #: they shadow same-named module globals (per-scope, like
        #: _attr_origin)
        self._local_shadows: Set[str] = set()
        #: module-level names bound to mutable containers (prescanned)
        self.mutable_globals: Set[str] = self._prescan_globals()
        top = FnAudit(
            name="<module>", qual=self.dotted_mod, scope=(),
            scope_kinds=(), cls=None, class_path=None, params=[], line=1,
        )
        audit.functions.append(top)
        self.fn_stack: List[FnAudit] = [top]

    def _prescan_globals(self) -> Set[str]:
        out: Set[str] = set()
        for stmt in self.module.tree.body:
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            mutable = isinstance(
                value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                        ast.SetComp, ast.DictComp)
            )
            if not mutable and isinstance(value, ast.Call):
                term = _terminal_name(value.func)
                mutable = term in _MUTABLE_GLOBAL_CTORS
            if not mutable:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
        # names rebound via an explicit `global` declaration count too
        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.Global):
                out.update(node.names)
        return out

    @staticmethod
    def _label_exempt(relpath: str) -> bool:
        base = relpath.rsplit("/", 1)[-1]
        if base in _LABEL_EXEMPT_BASENAMES:
            return True
        return any(relpath.startswith(d) for d in _LABEL_EXEMPT_DIRS)

    # ---------------------------------------------------------- imports

    def _resolve(self, expr: ast.AST) -> Optional[str]:
        """Dotted call path with import aliases folded in."""
        return resolve_dotted(expr, self.imports)

    # ---------------------------------------------------- lock bookkeeping

    def _lock_ctor(self, value: ast.AST) -> Optional[str]:
        """Return the threading ctor name when ``value`` constructs a lock."""
        if not isinstance(value, ast.Call):
            return None
        resolved = self._resolve(value.func) or ""
        term = resolved.rsplit(".", 1)[-1]
        if term in _THREADING_LOCK_CTORS and (
            resolved.startswith("threading.") or resolved == term
        ):
            return term
        return None

    def _async_lock_ctor(self, value: ast.AST) -> Optional[str]:
        """Return the asyncio ctor name when ``value`` constructs an
        asyncio synchronization primitive (v4 lock identity). The
        explicit ``asyncio.`` prefix is required: a bare ``Lock()`` with
        no import evidence stays a thread lock — the conservative
        default for the race pass."""
        if not isinstance(value, ast.Call):
            return None
        resolved = self._resolve(value.func) or ""
        term = resolved.rsplit(".", 1)[-1]
        if term in _ASYNCIO_LOCK_CTORS and resolved.startswith("asyncio."):
            return term
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        ctor = self._lock_ctor(node.value)
        async_ctor = None if ctor else self._async_lock_ctor(node.value)
        if ctor or async_ctor:
            for tgt in node.targets:
                name = _terminal_name(tgt)
                if name:
                    self.known_locks[name] = ctor in _REENTRANT_CTORS
                    if async_ctor:
                        self.known_async_locks.add(name)
                    else:
                        self.known_async_locks.discard(name)
        # `outer = self` inside a class method: attribute accesses on
        # `outer` (typically from a nested handler class) are accesses
        # on THIS class's instance — the webhook/RouteServer idiom.
        # ANY other assignment to a tracked name invalidates its alias/
        # type so a later unrelated `outer = make_thing()` can't be
        # misattributed (both maps are also saved/copied per scope).
        is_self_alias = (
            isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and bool(self.class_stack)
        )
        ctor_path: Optional[str] = None
        if isinstance(node.value, ast.Call):
            path = self._resolve(node.value.func)
            term = path.rsplit(".", 1)[-1] if path else None
            if path and term and term[:1].isupper():
                ctor_path = path
        for tgt in node.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if is_self_alias:
                self.self_aliases[tgt.id] = self.class_stack[-1]
            else:
                self.self_aliases.pop(tgt.id, None)
            # `fleet = FleetController(...)`: remember the ctor path so
            # a later `Thread(target=fleet.run)` can resolve the method
            if ctor_path is not None:
                self.var_types[tgt.id] = ctor_path
            else:
                self.var_types.pop(tgt.id, None)
        # parameter-callback linking, store half: `self.A = p` /
        # `self.A[k] = p` with p a parameter of the enclosing function
        fn = self.fn_stack[-1]
        if isinstance(node.value, ast.Name) and node.value.id in fn.params:
            for tgt in node.targets:
                attr_tgt = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                if isinstance(
                    attr_tgt, ast.Attribute
                ) and self._self_class_of(attr_tgt.value):
                    fn.param_attr_stores.append(
                        (node.value.id, attr_tgt.attr)
                    )
        # `event = self._queue.get()`: calls of `event` later in the
        # function are calls through the queue attribute
        if (
            isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr in _CONTAINER_GET_METHODS
            and isinstance(node.value.func.value, ast.Attribute)
            and self._self_class_of(node.value.func.value.value)
        ):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._attr_origin[tgt.id] = node.value.func.value.attr
        self.generic_visit(node)

    def _is_lock_expr(self, expr: ast.AST) -> bool:
        name = _terminal_name(expr)
        if name is None:
            return False
        return name in self.known_locks or bool(_LOCKY_NAME.search(name))

    def _lock_site(self, expr: ast.AST, node: ast.AST) -> LockSite:
        name = _terminal_name(expr) or "<lock>"
        display = _dotted(expr) or name
        # self.X inside class C -> modbase.C.X; everything else keeps its
        # dotted path under the module, so distinct locks stay distinct
        if display.startswith("self.") and self.class_stack:
            qual = f"{self.modbase}.{self.class_stack[-1]}.{display[5:]}"
        else:
            qual = f"{self.modbase}.{display}"
        if name in self.known_async_locks:
            kind = "async"
        elif name in self.known_locks:
            kind = "thread"
        else:
            kind = "unknown"
        if kind == "async":
            self.audit.async_lock_quals.add(qual)
        return LockSite(
            qual=qual,
            display=display,
            file=self.module.relpath,
            line=node.lineno,
            text=self.module.line_text(node.lineno),
            reentrant=self.known_locks.get(name, False),
            kind=kind,
        )

    # ------------------------------------------------------------- with

    def visit_With(self, node: ast.With) -> None:
        # Python enters with-items left to right, so item N's context
        # expression runs — and its lock is ordered — under every lock
        # item 0..N-1 acquired: `with a, b:` is exactly `with a: with b:`
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            self.visit(expr)
            if item.optional_vars:
                self.visit(item.optional_vars)
            if not self._is_lock_expr(expr):
                continue
            site = self._lock_site(expr, node)
            if self.lock_stack:
                self.audit.lock_edges.append((self.lock_stack[-1], site))
            else:
                # acquired while holding nothing: this function's entry
                # lock — what a caller holding X transitively orders
                # X ahead of (callgraph.py consumes it)
                self.fn_stack[-1].entry_locks.append(site)
            self.lock_stack.append(site)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        del self.lock_stack[len(self.lock_stack) - pushed:]

    # same shape (withitems + body); async lock types differ but the
    # ordering/blocking invariants don't. Entering an ``async with``
    # awaits (``__aenter__``) — a suspension point under whatever locks
    # are held OUTSIDE the new acquisitions, recorded before delegating.
    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._record_await(node)
        self.visit_With(node)  # type: ignore[arg-type]

    # ------------------------------------------------------- scope resets

    def _class_path(self) -> Optional[Tuple[str, ...]]:
        """Scope prefix up to and including the innermost class."""
        if not self.class_stack:
            return None
        names = [n for _, n in self.scope_stack]
        for i in range(len(self.scope_stack) - 1, -1, -1):
            if self.scope_stack[i][0] == "class":
                return tuple(names[: i + 1])
        return None

    def _visit_scope(
        self, node: "ast.FunctionDef | ast.AsyncFunctionDef", name: str
    ) -> None:
        saved_stack, self.lock_stack = self.lock_stack, []
        saved_released = self._finally_released
        saved_loop, self.loop_depth = self.loop_depth, 0
        saved_origin, self._attr_origin = self._attr_origin, {}
        saved_shadows = self._local_shadows
        self._local_shadows = self._collect_local_bindings(node)
        # nested scopes SEE enclosing aliases/typed locals (closures:
        # the Handler-in-__init__ idiom) but their own bindings must
        # not leak back out
        saved_aliases = self.self_aliases
        self.self_aliases = dict(saved_aliases)
        saved_types = self.var_types
        self.var_types = dict(saved_types)
        self._finally_released = self._collect_finally_releases(node)
        self.func_stack.append(name)
        scope = tuple(n for _, n in self.scope_stack)
        fn = FnAudit(
            name=name,
            qual=".".join((self.dotted_mod,) + scope + (name,)),
            scope=scope,
            scope_kinds=tuple(k for k, _ in self.scope_stack),
            cls=self.class_stack[-1] if self.class_stack else None,
            class_path=self._class_path(),
            params=[a.arg for a in node.args.args],
            line=node.lineno,
            node=node,
            handler_root=self._is_handler_method(name),
            is_async=isinstance(node, ast.AsyncFunctionDef),
        )
        self.audit.functions.append(fn)
        self.fn_stack.append(fn)
        self.scope_stack.append(("fn", name))
        self.generic_visit(node)
        self.scope_stack.pop()
        self.fn_stack.pop()
        self.func_stack.pop()
        self.lock_stack = saved_stack
        self._finally_released = saved_released
        self.loop_depth = saved_loop
        self._attr_origin = saved_origin
        self._local_shadows = saved_shadows
        self.self_aliases = saved_aliases
        self.var_types = saved_types
        self._finalize_prespawn(fn)

    def _is_handler_method(self, name: str) -> bool:
        """``do_*`` methods of ``*RequestHandler`` subclasses run on
        per-request threads of a ThreadingHTTPServer — thread roots the
        spawn site (stdlib internals) never shows."""
        if not name.startswith("do_") or not self.class_stack:
            return False
        path = self._class_path()
        bases = self._class_bases.get(path or (), [])
        return any(b.endswith("RequestHandler") for b in bases)

    @staticmethod
    def _collect_local_bindings(
        node: "ast.FunctionDef | ast.AsyncFunctionDef",
    ) -> Set[str]:
        """Names this function binds (Name stores, for/with/except
        targets, params) minus its ``global`` declarations — they
        shadow same-named module globals. Nested defs are separate
        scopes and are not descended into."""
        out: Set[str] = {a.arg for a in node.args.args}
        out.update(a.arg for a in node.args.kwonlyargs)
        if node.args.vararg:
            out.add(node.args.vararg.arg)
        if node.args.kwarg:
            out.add(node.args.kwarg.arg)
        declared_global: Set[str] = set()
        stack = list(node.body)
        while stack:
            stmt = stack.pop()
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                       ast.Lambda)
            ):
                continue
            if isinstance(stmt, ast.Global):
                declared_global.update(stmt.names)
            elif isinstance(stmt, ast.Name) and isinstance(
                stmt.ctx, ast.Store
            ):
                out.add(stmt.id)
            stack.extend(ast.iter_child_nodes(stmt))
        return out - declared_global

    @staticmethod
    def _finalize_prespawn(fn: FnAudit) -> None:
        """Writes lexically before the first ``.start()`` in the
        function that spawns a thread happen-before the spawn — the
        init-before-spawn pattern. Marked ``prespawn`` (not ``init``):
        the exemption only holds against the spawned thread, so the
        race pass re-checks that the spawning function itself is not
        invoked concurrently."""
        if not any(r.kind == "thread" for r in fn.refs):
            return
        starts = [
            c.line for c in fn.calls if c.term == "start" and c.bare is None
        ]
        if not starts:
            return
        first = min(starts)
        for a in fn.accesses:
            if a.kind == "write" and a.line < first:
                a.prespawn = True

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_scope(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_scope(node, node.name)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved, self.lock_stack = self.lock_stack, []
        self.generic_visit(node)
        self.lock_stack = saved

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.scope_stack.append(("class", node.name))
        self._class_bases[tuple(n for _, n in self.scope_stack)] = [
            t for t in (_terminal_name(b) for b in node.bases)
            if t is not None
        ]
        saved, self.lock_stack = self.lock_stack, []
        self.generic_visit(node)
        self.lock_stack = saved
        self.scope_stack.pop()
        self.class_stack.pop()

    def visit_For(self, node: ast.For) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_AsyncFor(self, node: ast.AsyncFor) -> None:
        # every iteration awaits ``__anext__`` — one recorded
        # suspension point stands in for all of them
        self._record_await(node)
        self.visit_For(node)  # type: ignore[arg-type]

    # ------------------------------------------------- v4 await tracking

    def _record_await(self, node: ast.AST) -> None:
        fn = self.fn_stack[-1]
        if not fn.is_async:
            return
        line = getattr(node, "lineno", 1)
        fn.awaits.append(AwaitSite(
            line=line,
            text=self.module.line_text(line),
            locks=frozenset(s.qual for s in self.lock_stack),
            thread_locks=tuple(
                s for s in self.lock_stack if s.kind == "thread"
            ),
        ))

    def visit_Await(self, node: ast.Await) -> None:
        self._record_await(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    # ---------------------------------------------------------- raw acquire

    def _collect_finally_releases(self, fn: ast.AST) -> Set[str]:
        """Terminal lock names released inside any ``finally`` in ``fn``
        (not descending into nested defs)."""
        out: Set[str] = set()
        stack = list(getattr(fn, "body", []))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in ast.walk(stmt):
                        if (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "release"
                        ):
                            name = _terminal_name(sub.func.value)
                            if name:
                                out.add(name)
            stack.extend(ast.iter_child_nodes(node))
        return out

    # ------------------------------------------------------------- calls

    # ---------------------------------------------- v3 site collection

    def _self_class_of(self, expr: ast.AST) -> Optional[str]:
        """Class whose instance ``expr`` denotes: ``self`` (innermost
        class) or a recorded ``x = self`` alias."""
        if not isinstance(expr, ast.Name):
            return None
        if expr.id == "self" and self.class_stack:
            return self.class_stack[-1]
        return self.self_aliases.get(expr.id)

    def _maybe_ref(
        self, expr: ast.AST, kind: str, self_concurrent: bool = False
    ) -> None:
        """Record ``expr`` as a thread-spawn target reference when it
        is reference-shaped; the resolver (threads.py) drops anything
        that doesn't name a real function."""
        site: Optional[RefSite] = None
        line = getattr(expr, "lineno", 1)
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            cls = self._self_class_of(expr.value)
            if cls is not None:
                site = RefSite(
                    kind=kind, attr_self=expr.attr, cls=cls, bare=None,
                    resolved=None, recv_class=None, line=line,
                    self_concurrent=self_concurrent,
                )
            elif expr.value.id in self.var_types:
                # typed-local receiver (`agent.run` with `agent =
                # CCManagerAgent(...)`): a loop-spawn almost always
                # constructs a FRESH instance per iteration (bench's
                # per-node agents), so the root does not race itself
                # on instance state
                site = RefSite(
                    kind=kind, attr_self=None, cls=None, bare=None,
                    resolved=None,
                    recv_class=(
                        f"{self.var_types[expr.value.id]}.{expr.attr}"
                    ),
                    line=line, self_concurrent=False,
                )
        if site is None and isinstance(expr, (ast.Name, ast.Attribute)):
            if isinstance(expr, ast.Name):
                site = RefSite(
                    kind=kind, attr_self=None, cls=None, bare=expr.id,
                    resolved=None, recv_class=None, line=line,
                    self_concurrent=self_concurrent,
                )
            else:
                resolved = self._resolve(expr)
                if resolved:
                    site = RefSite(
                        kind=kind, attr_self=None, cls=None, bare=None,
                        resolved=resolved, recv_class=None, line=line,
                        self_concurrent=self_concurrent,
                    )
        if site is not None:
            self.fn_stack[-1].refs.append(site)

    def _arg_ref(self, pos: "int | str", expr: ast.AST) -> Optional[ArgRef]:
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            cls = self._self_class_of(expr.value)
            if cls is not None:
                return ArgRef(
                    pos=pos, attr_self=expr.attr, cls=cls, bare=None,
                    dotted=None,
                )
            if expr.value.id in self.var_types:
                return ArgRef(
                    pos=pos, attr_self=None, cls=None, bare=None,
                    dotted=f"{self.var_types[expr.value.id]}.{expr.attr}",
                )
            resolved = self._resolve(expr)
            if resolved:
                return ArgRef(
                    pos=pos, attr_self=None, cls=None, bare=None,
                    dotted=resolved,
                )
        elif isinstance(expr, ast.Name):
            return ArgRef(
                pos=pos, attr_self=None, cls=None, bare=expr.id, dotted=None,
            )
        return None

    def _collect_arg_refs(self, node: ast.Call) -> List[ArgRef]:
        """Reference-shaped args, looking through dict/list/tuple
        literals (callback tables like RouteServer's ``routes``)."""
        out: List[ArgRef] = []
        args: List[Tuple["int | str", ast.AST]] = list(enumerate(node.args))
        args += [(k.arg, k.value) for k in node.keywords if k.arg]
        for pos, expr in args:
            values: List[ast.AST] = [expr]
            if isinstance(expr, ast.Dict):
                values = [v for v in expr.values if v is not None]
            elif isinstance(expr, (ast.List, ast.Tuple)):
                values = list(expr.elts)
            for v in values:
                ref = self._arg_ref(pos, v)
                if ref is not None:
                    out.append(ref)
        return out

    def _record_access(
        self, key: Tuple[str, ...], kind: str, node: ast.AST
    ) -> None:
        if len(self.fn_stack) < 2:
            return  # module top level: import time is single-threaded
        fn = self.fn_stack[-1]
        line = getattr(node, "lineno", 1)
        fn.accesses.append(
            AccessSite(
                key=key,
                kind=kind,
                locks=frozenset(s.qual for s in self.lock_stack),
                init=fn.name == "__init__",
                fn_qual=fn.qual,
                file=self.module.relpath,
                line=line,
                text=self.module.line_text(line),
                suppressed=self.module.suppressed("race-lockset", line),
            )
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        cls = self._self_class_of(node.value)
        if (
            cls is not None
            and id(node) not in self._call_func_attrs
            and node.attr not in self.known_locks
            and not _LOCKY_NAME.search(node.attr)
        ):
            write = isinstance(node.ctx, (ast.Store, ast.Del)) or (
                id(node) in self._mutated_receivers
            )
            self._record_access(
                ("attr", cls, node.attr), "write" if write else "read", node
            )
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if (
            node.id in self.mutable_globals
            and len(self.fn_stack) > 1
            # Python scoping: a name ASSIGNED in the function without a
            # `global` declaration is function-local — it shadows the
            # module global and never touches shared state
            and node.id not in self._local_shadows
        ):
            write = isinstance(node.ctx, (ast.Store, ast.Del)) or (
                id(node) in self._mutated_receivers
            )
            self._record_access(
                ("global", node.id), "write" if write else "read", node
            )
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # `self.map[k] = v` / `G[k] = v`: the subscript store mutates
        # the container the receiver names
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._mutated_receivers.add(id(node.value))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            self._call_func_attrs.add(id(func))
        resolved = self._resolve(func)
        term = _terminal_name(func)

        # raw-acquire: lock.acquire() outside with, without finally release
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            if self._is_lock_expr(func.value):
                name = _terminal_name(func.value)
                if name not in self._finally_released:
                    self.audit.add(
                        "raw-acquire",
                        node,
                        f"raw {_dotted(func) or 'acquire'}() — use `with "
                        f"{_dotted(func.value) or name}:` or pair with "
                        "try/finally release",
                    )

        # blocking sites: recorded for every function (the transitive
        # pass needs them), flagged directly only when a lock is held
        is_blocking = bool(resolved) and any(
            resolved == p or resolved.startswith(p)
            for p in _BLOCKING_PREFIXES
        )
        is_executor_wait = (
            not is_blocking
            and isinstance(func, ast.Attribute)
            and func.attr in _EXECUTOR_WAIT_METHODS
        )
        if is_blocking or is_executor_wait:
            what = (
                str(resolved) if is_blocking
                else f"{_dotted(func) or func.attr}()"
            )
            self.fn_stack[-1].blocking.append(
                BlockSite(
                    what=what,
                    file=self.module.relpath,
                    line=node.lineno,
                    text=self.module.line_text(node.lineno),
                    suppressed=self.module.suppressed(
                        "blocking-under-lock", node.lineno
                    ),
                )
            )
        if self.lock_stack:
            held = self.lock_stack[-1]
            if is_blocking:
                self.audit.add(
                    "blocking-under-lock",
                    node,
                    f"{resolved} called while holding {held.display} "
                    f"(acquired line {held.line}) — blocking inside a "
                    "critical section convoys every other waiter",
                )
            # executor waits: Future.result() blocks until a WORKER
            # thread finishes — if that worker (e.g. a flip-executor
            # task) ever needs the held lock, this is a deadlock, not a
            # convoy. Method-name matched because a bare future has no
            # resolvable module path.
            elif is_executor_wait:
                self.audit.add(
                    "blocking-under-lock",
                    node,
                    f"{_dotted(func) or func.attr}() while holding "
                    f"{held.display} (acquired line {held.line}) — a "
                    "future/executor wait under a lock deadlocks against "
                    "any worker that needs the same lock; collect results "
                    "outside the critical section",
                )

        # the call graph's raw material: one record per call site
        attr_self: Optional[str] = None
        call_cls: Optional[str] = None
        bare: Optional[str] = None
        recv_class: Optional[str] = None
        if isinstance(func, ast.Name):
            if func.id in self._attr_origin:
                # `task = self._q.get(); task()` — a call through the
                # queue attribute (parameter-callback linking)
                attr_self = self._attr_origin[func.id]
                call_cls = self.class_stack[-1] if self.class_stack else None
            else:
                bare = func.id
        elif isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            recv_cls = self._self_class_of(func.value)
            if recv_cls is not None:
                # `self.m(...)` or `outer._bump(...)` through an alias
                attr_self = func.attr
                call_cls = recv_cls
            elif func.value.id in self.var_types:
                recv_class = f"{self.var_types[func.value.id]}.{func.attr}"
        elif isinstance(func, ast.Subscript) and isinstance(
            func.value, ast.Attribute
        ):
            table_cls = self._self_class_of(func.value.value)
            if table_cls is not None:
                # `self.routes[path](...)` — a call through a callback
                # table
                attr_self = func.value.attr
                call_cls = table_cls
        self.fn_stack[-1].calls.append(
            CallRecord(
                attr_self=attr_self,
                cls=call_cls,
                bare=bare,
                resolved=resolved,
                term=term,
                recv_class=recv_class,
                line=node.lineno,
                held=self.lock_stack[-1] if self.lock_stack else None,
                held_locks=frozenset(s.qual for s in self.lock_stack),
                arg_refs=self._collect_arg_refs(node),
            )
        )

        # thread roots (threads.py resolves)
        if resolved == "threading.Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._maybe_ref(
                        kw.value, "thread",
                        self_concurrent=self.loop_depth > 0,
                    )
        elif (
            isinstance(func, ast.Attribute)
            and func.attr == "submit"
            and node.args
        ):
            self._maybe_ref(node.args[0], "submit", self_concurrent=True)

        # parameter-callback linking, container-store half:
        # `self._q.put_nowait(task)` with task a parameter
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _CONTAINER_STORE_METHODS
            and isinstance(func.value, ast.Attribute)
            and self._self_class_of(func.value.value) is not None
            and node.args
            and isinstance(node.args[0], ast.Name)
            and node.args[0].id in self.fn_stack[-1].params
        ):
            self.fn_stack[-1].param_attr_stores.append(
                (node.args[0].id, func.value.attr)
            )

        # in-place mutators: `self.chips.append(x)` writes `chips`
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _MUTATOR_METHODS
        ):
            recv = func.value
            if isinstance(recv, ast.Attribute) or (
                isinstance(recv, ast.Name) and recv.id in self.mutable_globals
            ):
                self._mutated_receivers.add(id(recv))

        # metric declarations (`term` computed at the top of the visit)
        if (
            term in _METRIC_CTORS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            name = node.args[0].value
            if _METRIC_NAME_RE.match(name):
                self._decl_nodes.add(id(node.args[0]))
                self.audit.metric_decls.setdefault(name, []).append(
                    (
                        self.module.relpath,
                        node.lineno,
                        self.module.line_text(node.lineno),
                    )
                )

        # watchdog series declarations (ISSUE 15): WatchSeries("...")
        # or WatchSeries(metric="...") — the referenced family must be
        # a declared metric (checked in metric_findings). The literal
        # is exempted from the generic tpu_cc_* use pass so a typo
        # yields ONE watchdog-flavored finding, not two.
        if term == "WatchSeries":
            metric_arg: Optional[ast.expr] = None
            if node.args:
                metric_arg = node.args[0]
            else:
                for kw in node.keywords:
                    if kw.arg == "metric":
                        metric_arg = kw.value
                        break
            if (
                isinstance(metric_arg, ast.Constant)
                and isinstance(metric_arg.value, str)
            ):
                self._decl_nodes.add(id(metric_arg))
                self.audit.watch_series_refs.append(
                    (
                        metric_arg.value,
                        node.lineno,
                        self.module.line_text(node.lineno),
                    )
                )
        self.generic_visit(node)

    # ------------------------------------------------- mode exhaustiveness

    def _mode_member(self, expr: Optional[ast.AST]) -> Optional[str]:
        """``Mode.ON`` / ``modes.Mode.ON`` / ``Mode.ON.value`` -> "ON"."""
        if expr is None:
            return None
        resolved = self._resolve(expr)
        if not resolved:
            return None
        if resolved.endswith(".value"):
            resolved = resolved[: -len(".value")]
        head, _, member = resolved.rpartition(".")
        if member not in _MODE_MEMBERS:
            return None
        if head == "Mode" or head.endswith(".Mode"):
            return member
        return None

    def _mode_compare(
        self, test: ast.AST
    ) -> Optional[Tuple[str, Set[str]]]:
        """(subject, members) when ``test`` compares one expression against
        Mode members (``x is Mode.ON``, ``x == Mode.ON``, ``x in
        (Mode.ON, Mode.OFF)``), else None."""
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            return None
        op = test.ops[0]
        left, right = test.left, test.comparators[0]
        if isinstance(op, (ast.Eq, ast.Is)):
            for subject, member_expr in ((left, right), (right, left)):
                member = self._mode_member(member_expr)
                if member is not None:
                    key = _dotted(subject)
                    if key is not None:
                        return key, {member}
            return None
        if isinstance(op, ast.In) and isinstance(
            right, (ast.Tuple, ast.List, ast.Set)
        ):
            members = {self._mode_member(e) for e in right.elts}
            if None in members or not members:
                return None
            key = _dotted(left)
            if key is None:
                return None
            return key, {m for m in members if m is not None}
        return None

    @staticmethod
    def _else_raises(orelse: List[ast.stmt]) -> bool:
        for stmt in orelse:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise):
                    return True
        return False

    def visit_If(self, node: ast.If) -> None:
        if id(node) not in self._elif_seen:
            tests: List[ast.AST] = []
            cur = node
            while True:
                tests.append(cur.test)
                if len(cur.orelse) == 1 and isinstance(cur.orelse[0], ast.If):
                    cur = cur.orelse[0]
                    self._elif_seen.add(id(cur))
                else:
                    break
            parsed = [self._mode_compare(t) for t in tests]
            # a dispatch = >= 2 branches, every test a Mode compare on one
            # subject (single-member guards like `if mode is Mode.OFF:
            # return` are not dispatches)
            if len(parsed) >= 2 and all(p is not None for p in parsed):
                subjects = {p[0] for p in parsed if p}
                if len(subjects) == 1:
                    covered: Set[str] = set()
                    for p in parsed:
                        if p:
                            covered |= p[1]
                    if not covered >= _MODE_MEMBERS and not self._else_raises(
                        cur.orelse
                    ):
                        missing = ", ".join(
                            f"Mode.{m}" for m in sorted(_MODE_MEMBERS - covered)
                        )
                        self.audit.add(
                            "mode-exhaustive", node,
                            f"if/elif dispatch over Mode does not handle "
                            f"{missing} and has no else that raises — a new "
                            "mode member must fail loudly, not fall through",
                        )
        self.generic_visit(node)

    def visit_Dict(self, node: ast.Dict) -> None:
        members = {
            m for m in (self._mode_member(k) for k in node.keys)
            if m is not None
        }
        if len(members) >= 2 and not members >= _MODE_MEMBERS:
            missing = ", ".join(
                f"Mode.{m}" for m in sorted(_MODE_MEMBERS - members)
            )
            self.audit.add(
                "mode-exhaustive", node,
                f"dict dispatch keyed on Mode does not handle {missing} — "
                "cover every member (a lookup miss on a new mode is a "
                "silent KeyError/None at fleet scale)",
            )
        self.generic_visit(node)

    # ------------------------------------------------------------ except

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        # the pragma may sit on the except line, the line above, or the
        # first body line — wherever it reads best
        body_pragma = bool(node.body) and self.module.suppressed(
            "swallow", node.body[0].lineno
        )
        if (
            self._is_broad_handler(node.type)
            and not self._handler_ok(node)
            and not body_pragma
        ):
            self.audit.add(
                "swallow",
                node,
                "broad except swallows silently — re-raise, log, use the "
                "bound exception, or annotate "
                "`# ccaudit: allow-swallow(reason)`",
            )
        self.generic_visit(node)

    @staticmethod
    def _is_broad_handler(type_node: Optional[ast.AST]) -> bool:
        if type_node is None:
            return True  # bare except:
        if isinstance(type_node, ast.Tuple):
            names = [_terminal_name(e) for e in type_node.elts]
        else:
            names = [_terminal_name(type_node)]
        return any(n in ("Exception", "BaseException") for n in names)

    @staticmethod
    def _handler_ok(node: ast.ExceptHandler) -> bool:
        bound = node.name
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise):
                    return True
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _LOG_METHODS
                ):
                    return True
                if (
                    bound
                    and isinstance(sub, ast.Name)
                    and sub.id == bound
                    and isinstance(sub.ctx, ast.Load)
                ):
                    return True
        return False

    # ---------------------------------------------------------- constants

    def visit_Constant(self, node: ast.Constant) -> None:
        if not isinstance(node.value, str) or id(node) in self.docstrings:
            return
        if LABEL_PREFIX in node.value and not self.label_exempt:
            self.audit.add(
                "label-literal",
                node,
                f"hard-coded {LABEL_PREFIX}… literal — import the "
                "constant from tpu_cc_manager_torch.labels (the one protocol "
                "surface)",
            )
        if (
            _METRIC_NAME_RE.match(node.value)
            and node.value not in _METRIC_IGNORE
            and id(node) not in self._decl_nodes
        ):
            self.audit.metric_uses.append(
                (
                    node.value,
                    self.module.relpath,
                    node.lineno,
                    self.module.line_text(node.lineno),
                )
            )


def audit_module(module: Module) -> ModuleAudit:
    audit = ModuleAudit(module=module)
    walker = _Walker(audit)
    walker.visit(module.tree)
    audit.imports = walker.imports
    _collect_label_uses(module, walker.imports, audit)
    return audit


# ----------------------------------------------------- protocol liveness

#: Built by concatenation so this module's own source doesn't trip the
#: label-literal rule; a labels.py constant participates in the liveness
#: pass when its value carries one of these key markers.
_LABEL_KEY_MARKERS = ("tpu.google" + ".com/", "cloud.google" + ".com/")

_LABELS_MODULE_PREFIXES = ("tpu_cc_manager_torch.labels.", "labels.")


def _collect_label_uses(
    module: Module, imports: Dict[str, str], audit: ModuleAudit
) -> None:
    """Record every reference to a labels.py constant with its syntactic
    role: "write" (key of a dict display — how every label/annotation
    patch is built), "read" (.get()/subscript key, comparison operand),
    or "other" (selector strings, defaults, iteration — counts as both)."""
    if module.relpath.rsplit("/", 1)[-1] == "labels.py":
        return

    def const_of(expr: ast.AST) -> Optional[str]:
        resolved = resolve_dotted(expr, imports)
        if not resolved:
            return None
        for prefix in _LABELS_MODULE_PREFIXES:
            if resolved.startswith(prefix):
                return resolved[len(prefix):].split(".")[0]
        return None

    parents: Dict[int, ast.AST] = {}
    for parent in ast.walk(module.tree):
        for child in ast.iter_child_nodes(parent):
            parents[id(child)] = parent

    for node in ast.walk(module.tree):
        if not isinstance(node, (ast.Name, ast.Attribute)):
            continue
        name = const_of(node)
        if name is None:
            continue
        parent = parents.get(id(node))
        # the inner part of `L.CONST.items` — the outer node reports it
        if isinstance(parent, ast.Attribute) and const_of(parent):
            continue
        ctx = "other"
        if isinstance(parent, ast.Dict) and any(
            k is node for k in parent.keys
        ):
            ctx = "write"
        elif (
            isinstance(parent, ast.Call)
            and isinstance(parent.func, ast.Attribute)
            and parent.func.attr in ("get", "pop")
            and parent.args
            and parent.args[0] is node
        ):
            ctx = "read"
        elif isinstance(parent, ast.Subscript) and parent.slice is node:
            # `ann[CONST] = v` publishes the key; `d[CONST]` consumes it
            ctx = "write" if isinstance(parent.ctx, ast.Store) else "read"
        elif isinstance(parent, ast.Compare):
            ctx = "read"
        audit.label_uses.append((name, ctx))


def liveness_findings(audits: Sequence[ModuleAudit]) -> List[Finding]:
    """Cross-module protocol-liveness pass: every key-shaped constant
    labels.py exports must have at least one writer and one reader across
    the scanned tree — a one-sided or unused constant is dead (or
    silently drifted) protocol surface. Constants written by an external
    party (GKE, pod authors) carry a
    ``# ccaudit: allow-protocol-liveness(reason)`` pragma on their
    declaration line."""
    labels_mod: Optional[Module] = None
    for a in audits:
        if a.module.relpath.rsplit("/", 1)[-1] == "labels.py":
            labels_mod = a.module
            break
    # liveness is a cross-module property: with nothing but labels.py in
    # the scan there is no evidence either way
    if labels_mod is None or len(audits) < 2:
        return []

    consts: Dict[str, int] = {}
    for stmt in labels_mod.tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        strings = [
            n.value for n in ast.walk(value)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
        ]
        if not any(m in s for s in strings for m in _LABEL_KEY_MARKERS):
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                consts[tgt.id] = stmt.lineno

    uses: Dict[str, Set[str]] = {}
    for a in audits:
        for name, ctx in a.label_uses:
            uses.setdefault(name, set()).add(ctx)

    findings: List[Finding] = []
    for name, line in sorted(consts.items(), key=lambda kv: kv[1]):
        if labels_mod.suppressed("protocol-liveness", line):
            continue
        ctxs = uses.get(name, set())
        if not ctxs:
            message = (
                f"{name} has no reader or writer anywhere in the scanned "
                "tree — dead protocol surface (delete it, or pragma why "
                "it must stay)"
            )
        elif ctxs == {"read"}:
            message = (
                f"{name} is read but never written by this codebase — "
                "one-sided protocol surface; if an external party writes "
                "it, say so in a pragma"
            )
        elif ctxs == {"write"}:
            message = (
                f"{name} is written but never read by this codebase — "
                "one-sided protocol surface; if an external party reads "
                "it, say so in a pragma"
            )
        else:
            continue
        findings.append(
            Finding(
                file=labels_mod.relpath,
                line=line,
                rule="protocol-liveness",
                message=message,
                text=labels_mod.line_text(line),
            )
        )
    return findings


# ------------------------------------------------------------------ metrics


def metric_findings(audits: Sequence[ModuleAudit]) -> List[Finding]:
    """Cross-module metric-name pass: exactly one declaration per name;
    every non-declaration ``tpu_cc_*`` literal must match a declaration
    (modulo the Prometheus _bucket/_sum/_count series suffixes)."""
    decls: Dict[str, List[Tuple[str, int, str]]] = {}
    by_relpath = {a.module.relpath: a.module for a in audits}
    for a in audits:
        for name, sites in a.metric_decls.items():
            decls.setdefault(name, []).extend(sites)

    findings: List[Finding] = []

    def emit(rule: str, file: str, line: int, text: str, message: str) -> None:
        mod = by_relpath.get(file)
        if mod is not None and mod.suppressed(rule, line):
            return
        findings.append(
            Finding(file=file, line=line, rule=rule, message=message, text=text)
        )

    for name, sites in sorted(decls.items()):
        if len(sites) > 1:
            first = sites[0]
            for file, line, text in sites[1:]:
                emit(
                    "metric-name", file, line, text,
                    f"metric {name!r} declared more than once (first at "
                    f"{first[0]}:{first[1]}) — two expositions under one "
                    "name corrupt aggregation",
                )

    for a in audits:
        for name, file, line, text in a.metric_uses:
            base = name
            for suffix in _METRIC_SUFFIXES:
                if name.endswith(suffix) and name[: -len(suffix)] in decls:
                    base = name[: -len(suffix)]
                    break
            if base not in decls:
                emit(
                    "metric-name", file, line, text,
                    f"metric name {name!r} matches no "
                    "Counter/Gauge/Histogram/HistogramVec declaration — "
                    "declare it once or fix the typo",
                )

    # watchdog-declared series (ISSUE 15, the metric-name rule
    # extended): every WatchSeries metric must be a declared family —
    # whole-family watch, so no _bucket/_sum/_count leniency, and no
    # tpu_cc_ prefix gate (a typo outside the prefix must still fail).
    # Escape hatch: `# ccaudit: allow-metric-name(reason)` for series
    # aimed at externally-scraped metrics (same pragma the SLO
    # objective check honors).
    for a in audits:
        for name, line, text in a.watch_series_refs:
            if name not in decls:
                emit(
                    "metric-name", a.module.relpath, line, text,
                    f"watchdog series {name!r} matches no "
                    "Counter/Gauge/Histogram/HistogramVec declaration "
                    "— an anomaly detector over a metric nobody "
                    "renders can never fire; fix the name or pragma "
                    "an externally-scraped series",
                )
    return findings


# ------------------------------------------------------- direct node writes


#: Reconcile-path modules (ISSUE 6): node mutations issued from these
#: must route through the write-coalescing batcher (k8s.batch) — or its
#: carrier folds — not call the KubeClient write verbs directly. A
#: direct call here silently re-inflates the flip's write round trips
#: back toward the historical five. Legit exceptions (the fail-secure
#: state write, the drain protocol's immediately-visible pause labels,
#: the taint CAS that IS the batcher's carrier) carry an explicit
#: ``# ccaudit: allow-direct-node-write(reason)`` pragma.
RECONCILE_PATH_MODULES = frozenset({
    "tpu_cc_manager_torch/agent.py",
    "tpu_cc_manager_torch/engine.py",
    "tpu_cc_manager_torch/drain.py",
    "tpu_cc_manager_torch/flipexec.py",
    "tpu_cc_manager_torch/simlab/replica.py",
    # the shard layer hosts controllers; it must never write nodes
    # itself (ISSUE 11 — writes stay on the controllers' batched paths)
    "tpu_cc_manager_torch/shard.py",
})

#: the KubeClient write verbs that mutate a node object
_NODE_WRITE_VERBS = frozenset({
    "set_node_labels", "set_node_annotations", "patch_node",
    "replace_node",
})


def direct_write_findings(modules: Sequence[Module]) -> List[Finding]:
    """Flag direct node-write verb calls inside the reconcile-path
    module set (``direct-node-write``). Batcher internals (k8s/batch.py)
    are exempt by construction — they are the sanctioned writer."""
    findings: List[Finding] = []
    for mod in modules:
        if mod.relpath not in RECONCILE_PATH_MODULES:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in _NODE_WRITE_VERBS:
                continue
            if mod.suppressed("direct-node-write", node.lineno):
                continue
            findings.append(
                Finding(
                    file=mod.relpath,
                    line=node.lineno,
                    rule="direct-node-write",
                    message=(
                        f".{func.attr}() called directly from a "
                        "reconcile-path module — route node mutations "
                        "through the NodePatchBatcher (k8s.batch) or a "
                        "carrier fold so flip-path writes stay "
                        "coalesced; a deliberate ordered write needs "
                        "an allow-direct-node-write pragma naming why"
                    ),
                    text=mod.line_text(node.lineno),
                )
            )
    return findings


# ---------------------------------------------------------- planner bypass


#: Scan-path controller modules (ISSUE 7): fleet and policy scans must
#: read per-pool convergence/skew/divergence from the batched planner
#: kernel (plan.analyze_encoding / plan.analyze_pools), not re-derive
#: them with Python loops over node dicts — that is exactly the
#: per-node code the array-native planner refactor removed, and it
#: silently re-inflates scan cost from O(changed) back to O(fleet).
#: rollout.py is deliberately out of scope: its per-node label touches
#: are the actuation path (one write per node is the work itself), and
#: its analysis preflight already rides plan.analyze_fleet.
PLANNER_SCAN_MODULES = frozenset({
    "tpu_cc_manager_torch/fleet.py",
    "tpu_cc_manager_torch/policy.py",
    # shard.py scopes and hosts the scan controllers; a per-node mode
    # loop creeping in there is the same reintroduced Python scan
    "tpu_cc_manager_torch/shard.py",
})

#: mode-classification label constants: reading one of these per node
#: inside a loop is the signature of a reintroduced Python mode loop
_MODE_LABEL_ATTRS = frozenset({
    "CC_MODE_LABEL", "CC_MODE_STATE_LABEL", "DOCTOR_ANNOTATION",
})


def planner_bypass_findings(modules: Sequence[Module]) -> List[Finding]:
    """Flag per-node mode-label reads inside ``for``/``while`` loops in
    the scan-path controllers (``planner-bypass``). A deliberate
    exception carries ``# ccaudit: allow-planner-bypass(reason)``."""
    findings: List[Finding] = []
    for mod in modules:
        if mod.relpath not in PLANNER_SCAN_MODULES:
            continue
        # ast.walk visits a nested loop's body once per enclosing loop
        # — dedupe by position or one read double-reports
        seen: set = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if not (isinstance(node, ast.Attribute)
                        and node.attr in _MODE_LABEL_ATTRS):
                    continue
                key = (node.lineno, node.col_offset, node.attr)
                if key in seen:
                    continue
                seen.add(key)
                if mod.suppressed("planner-bypass", node.lineno):
                    continue
                findings.append(
                    Finding(
                        file=mod.relpath,
                        line=node.lineno,
                        rule="planner-bypass",
                        message=(
                            f"{node.attr} read inside a loop in a "
                            "scan-path controller — per-node mode "
                            "classification belongs in the batched "
                            "planner kernel (plan.analyze_encoding / "
                            "plan.analyze_pools), not a Python loop; "
                            "a deliberate per-node read needs an "
                            "allow-planner-bypass pragma naming why"
                        ),
                        text=mod.line_text(node.lineno),
                    )
                )
    return findings


# ------------------------------------------------------------ shard bypass


#: Modules that may hold shard-partition state (ISSUE 11): shard.py
#: itself plus the scan controllers and the simlab runner that embed
#: it. Pool->shard resolution must go through the consistent-hash
#: ring (``HashRing.owner_of``); reaching into a partition table with
#: any other key silently couples a shard to a partition it does not
#: own — exactly the cross-shard double-writer the ring exists to
#: prevent. A deliberate exception carries
#: ``# ccaudit: allow-shard-bypass(reason)``.
SHARD_AWARE_MODULES = frozenset({
    "tpu_cc_manager_torch/shard.py",
    "tpu_cc_manager_torch/fleet.py",
    "tpu_cc_manager_torch/policy.py",
    "tpu_cc_manager_torch/simlab/runner.py",
})

#: attribute names that hold a ring-derived pool partition table
_PARTITION_TABLES = frozenset({
    "_partition", "shard_pools", "owned_pools",
})

#: the sanctioned partition accessors; calling one with a hard-coded
#: shard id is definitionally a ring bypass
_PARTITION_ACCESSORS = frozenset({"pools_of"})

#: the hash-ring lookup names whose presence in a subscript key makes
#: the access sanctioned
_RING_LOOKUPS = frozenset({"owner_of", "shard_of_pool"})


def _uses_ring_lookup(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        func = sub.func
        if isinstance(func, ast.Attribute) and func.attr in _RING_LOOKUPS:
            return True
        if isinstance(func, ast.Name) and func.id in _RING_LOOKUPS:
            return True
    return False


def shard_bypass_findings(modules: Sequence[Module]) -> List[Finding]:
    """Flag cross-shard pool access outside the hash-ring lookup
    (``shard-bypass``): subscripting a partition table with a key that
    is not derived from ``owner_of()`` on the same expression, or
    calling a partition accessor with a hard-coded shard id."""
    findings: List[Finding] = []
    for mod in modules:
        if mod.relpath not in SHARD_AWARE_MODULES:
            continue
        for node in ast.walk(mod.tree):
            hit = None
            if isinstance(node, ast.Subscript):
                val = node.value
                name = None
                if isinstance(val, ast.Attribute):
                    name = val.attr
                elif isinstance(val, ast.Name):
                    name = val.id
                if (name in _PARTITION_TABLES
                        and not _uses_ring_lookup(node.slice)):
                    hit = (
                        f"partition table {name!r} subscripted without "
                        "a hash-ring lookup — resolve the owner with "
                        "HashRing.owner_of(pool) (or pragma a "
                        "deliberate cross-shard read with "
                        "allow-shard-bypass naming why)"
                    )
            elif isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in _PARTITION_ACCESSORS
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and not _uses_ring_lookup(node)):
                    hit = (
                        f".{func.attr}() called with a hard-coded "
                        "shard id — the pool->shard mapping belongs to "
                        "the consistent-hash ring, not a literal; a "
                        "deliberate exception needs an "
                        "allow-shard-bypass pragma naming why"
                    )
            if hit is None:
                continue
            if mod.suppressed("shard-bypass", node.lineno):
                continue
            findings.append(
                Finding(
                    file=mod.relpath,
                    line=node.lineno,
                    rule="shard-bypass",
                    message=hit,
                    text=mod.line_text(node.lineno),
                )
            )
    return findings


# ----------------------------------------------------------- region bypass


#: Modules that may hold region-placement state (ISSUE 16):
#: federation.py itself plus the multi-region simlab lab that embeds
#: it. Pool->region resolution must go through the ONE sanctioned
#: lookup (``FederationManager.owner_of`` / ``region_of_pool``, both
#: riding the region-affine ring walk); subscripting the spec-derived
#: region table with any other key silently couples a controller to a
#: sibling region's API server — the cross-region writer the
#: federation boundary exists to prevent. A deliberate exception
#: carries ``# ccaudit: allow-region-bypass(reason)``.
REGION_AWARE_MODULES = frozenset({
    "tpu_cc_manager_torch/federation.py",
    "tpu_cc_manager_torch/simlab/federation.py",
})

#: attribute names that hold the pool->region (or region->pools) table
_REGION_TABLES = frozenset({
    "_pool_region", "region_pools",
})

#: the sanctioned region lookups whose presence in a subscript key
#: makes the access derived, not hard-coded
_REGION_LOOKUPS = frozenset({"owner_of", "region_of_pool"})


def _uses_region_lookup(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        func = sub.func
        if isinstance(func, ast.Attribute) and func.attr in _REGION_LOOKUPS:
            return True
        if isinstance(func, ast.Name) and func.id in _REGION_LOOKUPS:
            return True
    return False


def region_bypass_findings(modules: Sequence[Module]) -> List[Finding]:
    """Flag cross-region placement access outside the sanctioned
    lookup (``region-bypass``, the shard-bypass rule's federation
    mirror): subscripting a region table with a key not derived from
    ``owner_of()`` / ``region_of_pool()`` on the same expression, or
    calling ``region_of_pool`` with a hard-coded pool literal."""
    findings: List[Finding] = []
    for mod in modules:
        if mod.relpath not in REGION_AWARE_MODULES:
            continue
        for node in ast.walk(mod.tree):
            hit = None
            if isinstance(node, ast.Subscript):
                val = node.value
                name = None
                if isinstance(val, ast.Attribute):
                    name = val.attr
                elif isinstance(val, ast.Name):
                    name = val.id
                if (name in _REGION_TABLES
                        and not _uses_region_lookup(node.slice)):
                    hit = (
                        f"region table {name!r} subscripted without the "
                        "sanctioned lookup — resolve placement with "
                        "FederationManager.owner_of(pool) / "
                        "region_of_pool(pool) (or pragma a deliberate "
                        "cross-region read with allow-region-bypass "
                        "naming why)"
                    )
            elif isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr == "region_of_pool"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and not _uses_region_lookup(node.args[0])):
                    hit = (
                        ".region_of_pool() called with a hard-coded "
                        "pool literal — the pool->region mapping "
                        "belongs to the federation spec resolved at "
                        "runtime, not a constant; a deliberate "
                        "exception needs an allow-region-bypass "
                        "pragma naming why"
                    )
            if hit is None:
                continue
            if mod.suppressed("region-bypass", node.lineno):
                continue
            findings.append(
                Finding(
                    file=mod.relpath,
                    line=node.lineno,
                    rule="region-bypass",
                    message=hit,
                    text=mod.line_text(node.lineno),
                )
            )
    return findings


# -------------------------------------------------------- poll in watch path


#: Reconcile-path modules where a wake primitive exists (ISSUE 14):
#: the rollout judge's delta wake (``Rollout._wake`` off the shared
#: informer stream), the drainers' watch-delta wake (``Drainer.wake``),
#: and the agent's stop event / queue conditions. A ``time.sleep``-
#: clocked loop in one of these modules re-introduces the interval tax
#: on the desired-write -> converged critical path that the
#: event-driven judge removed — wait on the wake primitive (with the
#: poll interval as the TIMEOUT, the liveness fallback) instead. A
#: deliberate poll carries ``# ccaudit: allow-poll(reason)``.
POLL_PATH_MODULES = frozenset({
    "tpu_cc_manager_torch/rollout.py",
    "tpu_cc_manager_torch/drain.py",
    "tpu_cc_manager_torch/agent.py",
})


def poll_in_watch_path_findings(modules: Sequence[Module]) -> List[Finding]:
    """Flag ``time.sleep`` calls lexically inside a ``for``/``while``
    loop in the watch-fed reconcile-path modules
    (``poll-in-watch-path``). Sleeps outside loops (one-shot backoffs)
    are not polls and pass; loop waits must ride a wake primitive
    (``Event.wait(timeout=poll_s)``) so the poll interval degrades to
    a liveness fallback instead of clocking every iteration."""
    findings: List[Finding] = []
    for mod in modules:
        if mod.relpath not in POLL_PATH_MODULES:
            continue
        imports = collect_imports(mod.tree)
        # ast.walk visits a nested loop's body once per enclosing loop
        # — dedupe by position or one sleep double-reports
        seen: set = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                resolved = resolve_dotted(node.func, imports)
                if resolved != "time.sleep":
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                if (mod.suppressed("poll", node.lineno)
                        or mod.suppressed("poll-in-watch-path",
                                          node.lineno)):
                    continue
                findings.append(
                    Finding(
                        file=mod.relpath,
                        line=node.lineno,
                        rule="poll-in-watch-path",
                        message=(
                            "time.sleep-clocked loop in a watch-fed "
                            "reconcile-path module — a wake primitive "
                            "is available here (the rollout judge's "
                            "delta wake, the drainer's watch-delta "
                            "wake, the agent's stop event): wait on "
                            "it with the poll interval as the "
                            "timeout, so the poll degrades to a "
                            "liveness fallback; a deliberate poll "
                            "needs an allow-poll pragma naming why"
                        ),
                        text=mod.line_text(node.lineno),
                    )
                )
    return findings


# ------------------------------------------------------- blocking in async


#: The event-loop modules (ISSUE 13): everything in these files that is
#: an ``async def`` runs ON the process's one kube I/O loop — a single
#: blocking call there stalls every multiplexed request, watch pump,
#: and overlapped flip side-task in the process at once. The analyzer
#: can't see the loop, but it can see the call shapes that block it.
ASYNC_CORE_MODULES = frozenset({
    "tpu_cc_manager_torch/k8s/aio.py",
    "tpu_cc_manager_torch/k8s/aio_bridge.py",
})

#: Resolved-dotted-path prefixes that block the loop: the clock
#: (``time.sleep`` — ``asyncio.sleep`` is the loop-safe spelling),
#: synchronous sockets, and the synchronous HTTP client stack.
_ASYNC_BLOCKING_PREFIXES = (
    "time.sleep",
    "socket.",
    "http.client.",
)


def _async_blocking_hit(node: ast.Call,
                        imports: Dict[str, str]) -> Optional[str]:
    """The human-readable violation for a call inside an ``async def``
    body, or None."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr == "result":
        # concurrent.futures.Future.result() parks the loop thread on
        # another thread's progress — the deadlock shape the bridge
        # exists to prevent (asyncio.wrap_future/await is the fix)
        return (".result() blocks the event loop on another thread — "
                "await asyncio.wrap_future(...) instead")
    resolved = resolve_dotted(func, imports)
    if resolved is None:
        return None
    for prefix in _ASYNC_BLOCKING_PREFIXES:
        if resolved == prefix or resolved.startswith(prefix):
            return (f"{resolved} is a synchronous blocking call — on "
                    "the kube I/O loop it stalls every multiplexed "
                    "request in the process (use the asyncio "
                    "equivalent, or run_in_executor for genuinely "
                    "blocking work)")
    return None


def _walk_async_body(fn: ast.AsyncFunctionDef):
    """Yield nodes lexically inside an ``async def``, NOT descending
    into nested synchronous ``def``s (those run wherever they're
    called — usually an executor — and must not be flagged as loop
    code). Nested ``async def``s are separate roots in the caller's
    iteration, so they're skipped here too to avoid double-visits."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def blocking_in_async_findings(modules: Sequence[Module]) -> List[Finding]:
    """Flag blocking calls inside ``async def`` bodies in the async
    kube core (``blocking-in-async``): ``time.sleep``, synchronous
    ``socket``/``http.client`` calls, and ``.result()`` waits. A
    deliberate exception carries
    ``# ccaudit: allow-blocking-in-async(reason)``."""
    findings: List[Finding] = []
    for mod in modules:
        if mod.relpath not in ASYNC_CORE_MODULES:
            continue
        imports = collect_imports(mod.tree)
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in _walk_async_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                hit = _async_blocking_hit(node, imports)
                if hit is None:
                    continue
                if mod.suppressed("blocking-in-async", node.lineno):
                    continue
                findings.append(
                    Finding(
                        file=mod.relpath,
                        line=node.lineno,
                        rule="blocking-in-async",
                        message=(
                            f"inside async def {fn.name}: {hit}; a "
                            "deliberate exception needs an "
                            "allow-blocking-in-async pragma naming why"
                        ),
                        text=mod.line_text(node.lineno),
                    )
                )
    return findings
