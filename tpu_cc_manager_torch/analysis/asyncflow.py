"""ccaudit async-aware whole-program pass (v4).

Since ISSUE 13 the coordination substrate runs on an asyncio core
(``k8s/aio.py`` + ``k8s/aio_bridge.py``) that ISSUE 16's federation
layer multiplies across regions — yet every deep pass so far (lockset,
lockgraph, blocking) reasons only about *threads*. The event loop has
its own concurrency model: coroutines interleave at ``await`` points
(not instruction boundaries), asyncio locks exclude coroutines but not
threads, and loop-confined state may only be touched from the loop
thread. This module teaches the analyzer that model — four gated rule
families over the same per-function records and call graph the thread
passes consume (docs/analysis.md §v4 has the full contract):

``await-atomicity``
    An ``await`` inside an ``async def`` is a visible interleaving
    point. A read of a ``self.``-attribute or mutable module global
    followed by a write to the same location with an await between
    them is a check-then-act torn across the suspension — unless both
    ends sit inside one *asyncio* lock's critical section (thread
    locks don't count: they'd be held across the await, which is its
    own finding). The caller-held ⋂-fixpoint from the race pass
    (``lockset.caller_held_locks``) widens locksets the same way, so
    the ``_locked``-suffix convention carries over to coroutines.

``lock-across-await``
    Holding a *threading* lock at an ``await`` parks the entire event
    loop behind whatever thread owns the lock next — every multiplexed
    request stalls, and if the owner needs the loop to progress, the
    process deadlocks. Asyncio locks are the loop-safe spelling.

``loop-affinity`` / ``loop-self-deadlock``
    Objects constructed on the bridge loop (futures, queues, the
    client's conn pool) carry a LOOP-OWNED tag: attributes of
    async-core classes written inside ``async def`` bodies, or
    assigned an asyncio primitive. Touching one from sync land —
    a sync function not provably loop-confined via the call graph,
    or an attribute chain through a typed reference in any module —
    fires ``loop-affinity``; the sanctioned routes are
    ``get_bridge().call/submit/gather`` and
    ``loop.call_soon_threadsafe``. The inverse direction is worse:
    calling ``bridge.call()``/``bridge.gather()`` or a bridge
    future's ``.result()`` *from the loop thread* blocks the loop on
    work only the loop can run — the classic self-deadlock —
    and fires ``loop-self-deadlock`` at **error** severity.

``orphan-task`` / ``async-exception``
    ``create_task``/``ensure_future`` results must be awaited,
    gathered, stored on an attribute registry, or pragma'd
    (``allow-orphan-task(reason)``) — a dropped reference is
    garbage-collected mid-flight and its exceptions vanish; a
    coroutine-valued call whose result is discarded never runs at
    all. And in the async core's request paths, an ``except`` that
    exits without settling or propagating its pending queue entries
    breaks the gather-settles-everything contract (docs/io.md §"The
    async core") — checked via a settle-sink summary over the call
    graph (``_fail_inflight``/``set_exception``/``abort`` et al.,
    reached transitively from the handler body or a ``finally``).

All six rule ids take ``# ccaudit: allow-<rule>(reason)`` pragmas.
New findings surface at SARIF level ``warning`` (advisory families)
except ``loop-self-deadlock`` (``error``); the baseline ratchet gates
them all identically.
"""

from __future__ import annotations

import ast
from typing import (
    Dict,
    FrozenSet,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from tpu_cc_manager_torch.analysis import lockset
from tpu_cc_manager_torch.analysis.callgraph import CallGraph, callers_map
from tpu_cc_manager_torch.analysis.core import (
    Finding,
    Module,
    resolve_dotted,
)
from tpu_cc_manager_torch.analysis.rules import (
    ASYNC_CORE_MODULES,
    _ASYNCIO_LOCK_CTORS,
    _LOCKY_NAME,
    ModuleAudit,
)
from tpu_cc_manager_torch.analysis.threads import ThreadRoot

AWAIT_RULE = "await-atomicity"
LOCK_RULE = "lock-across-await"
AFFINITY_RULE = "loop-affinity"
DEADLOCK_RULE = "loop-self-deadlock"
TASK_RULE = "orphan-task"
EXC_RULE = "async-exception"

#: v4 ids that enter at SARIF ``warning``; ``loop-self-deadlock`` is
#: the one guaranteed-wrong shape and stays ``error``.
WARNING_RULES = frozenset({
    AWAIT_RULE, LOCK_RULE, AFFINITY_RULE, TASK_RULE, EXC_RULE,
})

#: asyncio ctors whose instances are loop-owned when stored on an
#: attribute (locks are excluded — they're filtered out of the access
#: domain entirely, same as thread locks).
_LOOP_OWNED_CTORS = frozenset({"Queue", "Event", "Future"})

#: methods whose *result* is loop-owned when stored on an attribute
_LOOP_OWNED_FACTORIES = frozenset({"create_future", "create_task"})

#: functions that settle or propagate pending request futures — the
#: sink set of the async-exception summary. ``retire`` counts: it
#: stops routing while the reader keeps settling what remains.
_SETTLE_SINKS = frozenset({
    "set_result", "set_exception", "_fail_inflight", "abort", "retire",
    "cancel",
})

#: exception terminal names that put an ``except`` in scope for the
#: async-exception rule: broad catches plus the transport failures a
#: request path sees mid-flight.
_BROAD_EXC = frozenset({"Exception", "BaseException"})
_TRANSPORT_EXC = frozenset({
    "OSError", "IOError", "ConnectionError", "ConnectionResetError",
    "ConnectionAbortedError", "BrokenPipeError", "IncompleteReadError",
    "TimeoutError", "CancelledError",
})

#: receivers whose ``create_task`` is structured-concurrency-owned
#: (``asyncio.TaskGroup``): the group awaits its tasks, so a discarded
#: handle is the documented idiom, not an orphan.
_TASKGROUP_NAMES = frozenset({"tg", "group", "taskgroup", "task_group"})


def _term(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _fn_body_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes lexically inside ``fn``, not descending into nested defs
    (they are separate functions with their own execution context)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _finding(mod: Module, rule: str, line: int, message: str) -> Finding:
    return Finding(
        file=mod.relpath,
        line=line,
        rule=rule,
        message=message,
        text=mod.line_text(line),
        severity="warning" if rule in WARNING_RULES else "error",
    )


# ------------------------------------------------------------ entry point


def async_findings(
    audits: Sequence[ModuleAudit],
    graph: CallGraph,
    roots: Dict[str, ThreadRoot],
) -> List[Finding]:
    """Run all four v4 families over already-collected audits."""
    findings: List[Finding] = []
    async_quals: Set[str] = set()
    for audit in audits:
        async_quals |= audit.async_lock_quals
    caller_held = lockset.caller_held_locks(audits, graph, roots)
    findings.extend(
        _atomicity_findings(audits, frozenset(async_quals), caller_held)
    )
    findings.extend(_affinity_findings(audits, graph))
    findings.extend(_deadlock_findings(audits))
    findings.extend(_task_findings(audits))
    findings.extend(_exception_findings(audits, graph))
    return sorted(set(findings))


# ------------------------------------------- family 1: await atomicity


def _atomicity_findings(
    audits: Sequence[ModuleAudit],
    async_quals: FrozenSet[str],
    caller_held: Dict[str, FrozenSet[str]],
) -> List[Finding]:
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        for fn in audit.functions:
            if not fn.is_async or not fn.awaits:
                continue
            # -- lock-across-await: a held THREAD lock at a suspension
            # point blocks the whole loop (one finding per await line)
            flagged_lines: Set[int] = set()
            for aw in fn.awaits:
                if not aw.thread_locks or aw.line in flagged_lines:
                    continue
                flagged_lines.add(aw.line)
                if mod.suppressed(LOCK_RULE, aw.line):
                    continue
                held = ", ".join(
                    sorted({s.display for s in aw.thread_locks})
                )
                out.append(_finding(
                    mod, LOCK_RULE, aw.line,
                    f"async def {fn.name} awaits while holding "
                    f"threading lock(s) {held} — every coroutine on "
                    "the loop now queues behind whatever thread owns "
                    "the lock next (and if that thread needs the loop, "
                    "the process deadlocks); use asyncio.Lock for "
                    "loop-side exclusion, or release before awaiting",
                ))
            # -- await-atomicity: read → await → write of one location
            # without a common asyncio-lock guard
            inherited = caller_held.get(fn.qual, frozenset())
            await_lines = sorted(aw.line for aw in fn.awaits)
            by_key: Dict[Tuple[str, ...], list] = {}
            for a in fn.accesses:
                if not a.init:
                    by_key.setdefault(a.key, []).append(a)
            for key in sorted(by_key):
                accs = by_key[key]
                reads = [a for a in accs if a.kind == "read"]
                writes = sorted(
                    (a for a in accs if a.kind == "write"),
                    key=lambda a: a.line,
                )
                if not reads or not writes:
                    continue
                fired = False
                for w in writes:
                    if fired:
                        break
                    for r in sorted(reads, key=lambda a: a.line):
                        if r.line > w.line:
                            break
                        spanning = [
                            ln for ln in await_lines
                            if r.line <= ln <= w.line
                        ]
                        if not spanning:
                            continue
                        guard = (
                            (r.locks | inherited)
                            & (w.locks | inherited)
                            & async_quals
                        )
                        if guard:
                            continue
                        if mod.suppressed(AWAIT_RULE, w.line):
                            fired = True  # deliberate: one pragma per key
                            break
                        name = (
                            f"self.{key[2]}" if key[0] == "attr"
                            else key[1]
                        )
                        out.append(_finding(
                            mod, AWAIT_RULE, w.line,
                            f"async def {fn.name} reads {name} (line "
                            f"{r.line}) and writes it here with an "
                            f"await between (line {spanning[0]}) — "
                            "every other coroutine on the loop can run "
                            "at that await, so the check-then-act is "
                            "torn; hold one asyncio.Lock across the "
                            "whole read-modify-write, or annotate "
                            f"`# ccaudit: allow-{AWAIT_RULE}(reason)` "
                            "if a single-loop invariant makes it safe",
                        ))
                        fired = True
                        break
    return out


# -------------------------------------------- family 2: loop affinity


def _core_audits(
    audits: Sequence[ModuleAudit],
) -> List[ModuleAudit]:
    return [
        a for a in audits if a.module.relpath in ASYNC_CORE_MODULES
    ]


def _loop_owned_attrs(
    audits: Sequence[ModuleAudit],
) -> Dict[Tuple[str, str], Set[str]]:
    """(module dotted, class) → attribute names that are LOOP-OWNED:
    written inside an ``async def`` (outside ``__init__``), or assigned
    a loop-bound asyncio object (queue/event/future/task). Lock-shaped
    names never appear (the walker filters them from the access
    domain), and asyncio *locks* are deliberately excluded here too —
    they are the sanctioned guard objects, not shared data."""
    owned: Dict[Tuple[str, str], Set[str]] = {}
    for audit in _core_audits(audits):
        for fn in audit.functions:
            if not fn.is_async:
                continue
            for a in fn.accesses:
                if a.key[0] == "attr" and a.kind == "write" and not a.init:
                    owned.setdefault(
                        (audit.dotted, a.key[1]), set()
                    ).add(a.key[2])
        imports = audit.imports
        for cls in ast.walk(audit.module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                if not _is_loop_owned_value(node.value, imports):
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and not _LOCKY_NAME.search(tgt.attr)
                    ):
                        owned.setdefault(
                            (audit.dotted, cls.name), set()
                        ).add(tgt.attr)
    return owned


def _is_loop_owned_value(value: ast.AST, imports: Dict[str, str]) -> bool:
    if not isinstance(value, ast.Call):
        return False
    func = value.func
    if isinstance(func, ast.Attribute) and (
        func.attr in _LOOP_OWNED_FACTORIES
    ):
        return True
    resolved = resolve_dotted(func, imports) or ""
    term = resolved.rsplit(".", 1)[-1]
    return (
        resolved.startswith("asyncio.")
        and term in _LOOP_OWNED_CTORS
        and term not in _ASYNCIO_LOCK_CTORS
    )


def _core_class_index(
    audits: Sequence[ModuleAudit],
) -> Dict[str, Tuple[str, str]]:
    """Resolvable names of async-core classes: both the full dotted
    path (``tpu_cc_manager_torch.k8s.aio.AsyncKubeClient``) and the bare
    class name for same-module references → (module dotted, class)."""
    index: Dict[str, Tuple[str, str]] = {}
    for audit in _core_audits(audits):
        for node in ast.walk(audit.module.tree):
            if isinstance(node, ast.ClassDef):
                index[f"{audit.dotted}.{node.name}"] = (
                    audit.dotted, node.name
                )
    return index


def _loop_confined_quals(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> Set[str]:
    """Sync functions in async-core modules provably reachable ONLY
    from coroutine context: every resolved call site is an ``async
    def`` or another loop-confined function. A sync function with no
    resolved caller is conservatively MIXED — it may be an entry point
    from any thread (greatest-fixpoint demotion)."""
    callers = callers_map(audits, graph)
    is_async: Dict[str, bool] = {}
    for audit in audits:
        for fn in audit.functions:
            is_async[fn.qual] = fn.is_async
    confined: Set[str] = set()
    for audit in _core_audits(audits):
        for fn in audit.functions:
            if fn.is_async or fn.name == "<module>":
                continue
            if callers.get(fn.qual):
                confined.add(fn.qual)
    changed = True
    while changed:
        changed = False
        for q in sorted(confined):
            ok = all(
                is_async.get(c, False) or c in confined
                for c in callers.get(q, ())
            )
            if not ok:
                confined.discard(q)
                changed = True
    return confined


def _affinity_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> List[Finding]:
    owned = _loop_owned_attrs(audits)
    out: List[Finding] = []
    # half 1: sync methods of async-core classes touching loop-owned
    # attributes while not provably loop-confined (the call graph is
    # the typestate carrier: reachability from coroutine context)
    confined = _loop_confined_quals(audits, graph)
    seen: Set[Tuple[str, int, str]] = set()
    for audit in _core_audits(audits):
        mod = audit.module
        for fn in audit.functions:
            if (
                fn.is_async
                or fn.name in ("<module>", "__init__")
                or fn.qual in confined
            ):
                continue
            for a in fn.accesses:
                if a.key[0] != "attr" or a.init:
                    continue
                if a.key[2] not in owned.get(
                    (audit.dotted, a.key[1]), ()
                ):
                    continue
                sig = (mod.relpath, a.line, a.key[2])
                if sig in seen or mod.suppressed(AFFINITY_RULE, a.line):
                    seen.add(sig)
                    continue
                seen.add(sig)
                out.append(_finding(
                    mod, AFFINITY_RULE, a.line,
                    f"{fn.name} is not provably loop-confined but "
                    f"{'writes' if a.kind == 'write' else 'reads'} "
                    f"loop-owned state self.{a.key[2]} — loop-owned "
                    "objects may only be touched on the bridge loop; "
                    "route through get_bridge().call/submit or "
                    "loop.call_soon_threadsafe, or annotate "
                    f"`# ccaudit: allow-{AFFINITY_RULE}(reason)`",
                ))
    # half 2: attribute chains through a typed reference, in any module.
    # A reference to an async-core class is only resolvable when the
    # bare class name appears somewhere in the source (aliased imports
    # still spell the original name at the import site), so modules
    # that never mention one skip the walk entirely — most of the tree.
    class_index = _core_class_index(audits)
    core_names = tuple({k.rsplit(".", 1)[-1] for k in class_index})
    relevant = [
        a for a in audits
        if any(name in a.module.source for name in core_names)
    ]
    attr_types = _attr_type_index(relevant, class_index)
    for audit in relevant:
        walker = _ChainWalker(audit, class_index, attr_types, owned)
        walker.visit(audit.module.tree)
        out.extend(walker.findings)
    return out


def _attr_type_index(
    audits: Sequence[ModuleAudit],
    class_index: Dict[str, Tuple[str, str]],
) -> Dict[Tuple[str, str, str], Tuple[str, str]]:
    """(module dotted, class, attr) → async-core class the attribute
    holds an instance of, from ``self.X = SomeCoreClass(...)``-shaped
    assignments (a ctor call anywhere in the value counts: ``aio or
    AsyncKubeClient(...)`` is the façade's idiom)."""
    index: Dict[Tuple[str, str, str], Tuple[str, str]] = {}
    for audit in audits:
        imports = audit.imports
        for cls in ast.walk(audit.module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                target_cls = _core_ctor_in(
                    node.value, imports, audit.dotted, class_index
                )
                if target_cls is None:
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        index[(audit.dotted, cls.name, tgt.attr)] = (
                            target_cls
                        )
    return index


def _core_ctor_in(
    value: ast.AST,
    imports: Dict[str, str],
    mod_dotted: str,
    class_index: Dict[str, Tuple[str, str]],
) -> Optional[Tuple[str, str]]:
    for node in ast.walk(value):
        if not isinstance(node, ast.Call):
            continue
        resolved = resolve_dotted(node.func, imports)
        if not resolved:
            continue
        hit = class_index.get(resolved) or class_index.get(
            f"{mod_dotted}.{resolved}"
        )
        if hit is not None:
            return hit
    return None


class _ChainWalker(ast.NodeVisitor):
    """Find ``<typed ref>.<loop-owned attr>`` touches in sync context:
    a local constructed from an async-core class, or a ``self.X``
    attribute recorded in the attr-type index. ``async def`` bodies are
    loop context and skipped; sync defs — including sync defs nested in
    coroutines, which run wherever they're called — are sync land."""

    def __init__(
        self,
        audit: ModuleAudit,
        class_index: Dict[str, Tuple[str, str]],
        attr_types: Dict[Tuple[str, str, str], Tuple[str, str]],
        owned: Dict[Tuple[str, str], Set[str]],
    ) -> None:
        self.audit = audit
        self.mod = audit.module
        self.imports = audit.imports
        self.class_index = class_index
        self.attr_types = attr_types
        self.owned = owned
        self.findings: List[Finding] = []
        self.class_stack: List[str] = []
        self.async_depth = 0
        self.local_types: Dict[str, Tuple[str, str]] = {}
        self._seen: Set[int] = set()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_AsyncFunctionDef(
        self, node: ast.AsyncFunctionDef
    ) -> None:
        self.async_depth += 1
        saved, self.local_types = self.local_types, {}
        self.generic_visit(node)
        self.local_types = saved
        self.async_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved_async, self.async_depth = self.async_depth, 0
        saved, self.local_types = self.local_types, {}
        self.generic_visit(node)
        self.local_types = saved
        self.async_depth = saved_async

    def visit_Assign(self, node: ast.Assign) -> None:
        hit = _core_ctor_in(
            node.value, self.imports, self.audit.dotted,
            self.class_index,
        )
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if hit is not None:
                    self.local_types[tgt.id] = hit
                else:
                    self.local_types.pop(tgt.id, None)
        self.generic_visit(node)

    def _base_type(self, expr: ast.AST) -> Optional[Tuple[str, str]]:
        if isinstance(expr, ast.Name):
            return self.local_types.get(expr.id)
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.class_stack
        ):
            return self.attr_types.get(
                (self.audit.dotted, self.class_stack[-1], expr.attr)
            )
        return None

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.async_depth == 0 and id(node) not in self._seen:
            base = self._base_type(node.value)
            if base is not None and node.attr in self.owned.get(
                base, ()
            ):
                self._seen.add(id(node))
                line = node.lineno
                if not self.mod.suppressed(AFFINITY_RULE, line):
                    self.findings.append(_finding(
                        self.mod, AFFINITY_RULE, line,
                        f"loop-owned state {base[1]}.{node.attr} "
                        "touched from sync land — only the bridge "
                        "loop may touch it; route through "
                        "get_bridge().call/submit/gather, or annotate "
                        f"`# ccaudit: allow-{AFFINITY_RULE}(reason)`",
                    ))
        self.generic_visit(node)


# ------------------------------------- family 2b: loop self-deadlock


def _deadlock_findings(
    audits: Sequence[ModuleAudit],
) -> List[Finding]:
    """``bridge.call``/``bridge.gather`` or a bridge-future
    ``.result()`` from INSIDE a coroutine: the loop blocks on work only
    the loop can run. Error severity — this is not a judgement call."""
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        if "async def" not in mod.source:
            continue
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            body_nodes = list(_fn_body_nodes(fn))
            bridge_futs: Set[str] = set()
            for node in body_nodes:
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    vf = node.value.func
                    if isinstance(vf, ast.Attribute) and vf.attr in (
                        "submit", "run_coroutine_threadsafe"
                    ):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                bridge_futs.add(tgt.id)
            for node in body_nodes:
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if not isinstance(func, ast.Attribute):
                    continue
                hit: Optional[str] = None
                if func.attr in ("call", "gather"):
                    recv = func.value
                    recv_is_bridge = (
                        isinstance(recv, ast.Call)
                        and _term(recv.func) == "get_bridge"
                    ) or (
                        _term(recv) is not None
                        and "bridge" in str(_term(recv)).lower()
                    )
                    if recv_is_bridge:
                        hit = (
                            f"bridge.{func.attr}() submits to this "
                            "loop and blocks the loop thread waiting "
                            "for it — the loop can never run the work "
                            "it is waiting on (self-deadlock); await "
                            "the coroutine directly"
                        )
                elif (
                    func.attr == "result"
                    and isinstance(func.value, ast.Name)
                    and func.value.id in bridge_futs
                ):
                    hit = (
                        f"{func.value.id}.result() waits on a bridge "
                        "future from the loop thread — if the work is "
                        "scheduled on this loop it can never start "
                        "(self-deadlock); await "
                        "asyncio.wrap_future(...) instead"
                    )
                if hit is None:
                    continue
                if mod.suppressed(DEADLOCK_RULE, node.lineno):
                    continue
                out.append(_finding(
                    mod, DEADLOCK_RULE, node.lineno,
                    f"inside async def {fn.name}: {hit}",
                ))
    return out


# ---------------------------------------- family 3: task lifecycle


def _is_task_spawn(node: ast.Call, imports: Dict[str, str]) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr not in ("create_task", "ensure_future"):
            return False
        recv = _term(func.value)
        return not (
            recv is not None and recv.lower() in _TASKGROUP_NAMES
        )
    resolved = resolve_dotted(func, imports)
    return resolved in (
        "asyncio.create_task", "asyncio.ensure_future"
    )


def _async_def_index(
    tree: ast.Module,
) -> Tuple[Set[str], Set[Tuple[str, str]]]:
    """Same-module coroutine functions: top-level bare names, and
    (class, method) pairs — the resolution domain for the
    discarded-coroutine half of the task-lifecycle rule."""
    bare: Set[str] = set()
    methods: Set[Tuple[str, str]] = set()
    for node in tree.body:
        if isinstance(node, ast.AsyncFunctionDef):
            bare.add(node.name)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.AsyncFunctionDef):
                    methods.add((node.name, sub.name))
    return bare, methods


def _task_findings(audits: Sequence[ModuleAudit]) -> List[Finding]:
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        # every shape this family flags spells one of these in source:
        # a spawn call, or a discarded call of a SAME-module coroutine
        if (
            "async def" not in mod.source
            and "create_task" not in mod.source
            and "ensure_future" not in mod.source
        ):
            continue
        imports = audit.imports
        coro_bare, coro_methods = _async_def_index(mod.tree)

        class_of_fn: Dict[int, Optional[str]] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        class_of_fn[id(sub)] = node.name

        for fn in ast.walk(mod.tree):
            if not isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            own_cls = class_of_fn.get(id(fn))
            body_nodes = list(_fn_body_nodes(fn))
            # built on first use: only functions that actually bind a
            # spawn to a name need the Name-load index
            loads: Optional[List[Tuple[str, int]]] = None
            for node in body_nodes:
                # discarded spawn / discarded coroutine
                if isinstance(node, ast.Expr) and isinstance(
                    node.value, ast.Call
                ):
                    call = node.value
                    line = call.lineno
                    if _is_task_spawn(call, imports):
                        if not mod.suppressed(TASK_RULE, line):
                            out.append(_finding(
                                mod, TASK_RULE, line,
                                "task handle discarded — an "
                                "unreferenced Task can be garbage-"
                                "collected mid-flight and its "
                                "exception is never observed; await "
                                "it, gather it, store it on a "
                                "registry, or annotate "
                                f"`# ccaudit: allow-{TASK_RULE}"
                                "(reason)`",
                            ))
                        continue
                    if _is_local_coro_call(
                        call, own_cls, coro_bare, coro_methods
                    ):
                        if not mod.suppressed(TASK_RULE, line):
                            out.append(_finding(
                                mod, TASK_RULE, line,
                                f"coroutine "
                                f"{_term(call.func)}() is created "
                                "but its result is discarded — the "
                                "body NEVER runs (a coroutine does "
                                "nothing until awaited); await it or "
                                "wrap it in create_task and keep the "
                                "handle",
                            ))
                        continue
                # bound-but-unused spawn
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and _is_task_spawn(node.value, imports)
                ):
                    name = node.targets[0].id
                    line = node.lineno
                    if loads is None:
                        loads = [
                            (n.id, n.lineno) for n in body_nodes
                            if isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Load)
                        ]
                    used = any(
                        n == name and ln >= line for n, ln in loads
                    )
                    if used or mod.suppressed(TASK_RULE, line):
                        continue
                    out.append(_finding(
                        mod, TASK_RULE, line,
                        f"task bound to {name!r} but never awaited, "
                        "gathered, cancelled, or stored — the handle "
                        "dies with this frame and the task becomes "
                        "an unobserved orphan; keep a reference or "
                        f"annotate `# ccaudit: allow-{TASK_RULE}"
                        "(reason)`",
                    ))
    return out


def _is_local_coro_call(
    call: ast.Call,
    own_cls: Optional[str],
    coro_bare: Set[str],
    coro_methods: Set[Tuple[str, str]],
) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in coro_bare
    if (
        isinstance(func, ast.Attribute)
        and isinstance(func.value, ast.Name)
        and func.value.id == "self"
        and own_cls is not None
    ):
        return (own_cls, func.attr) in coro_methods
    return False


# -------------------------------- family 4: async-exception fail-secure


def _settler_quals(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> Set[str]:
    """Functions that settle pending futures somewhere in their
    closure (the sink-summary: direct sink call, or any resolved
    callee reaching one — ``graph.reachable`` is cycle-safe and
    depth-bounded)."""
    direct: Set[str] = set()
    for audit in audits:
        for fn in audit.functions:
            if any(c.term in _SETTLE_SINKS for c in fn.calls):
                direct.add(fn.qual)
    settlers: Set[str] = set()
    for audit in audits:
        for fn in audit.functions:
            if graph.reachable([fn.qual]) & direct:
                settlers.add(fn.qual)
    return settlers


def _handler_in_scope(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        name = _term(e)
        if name in _BROAD_EXC or name in _TRANSPORT_EXC:
            return True
    return False


def _calls_settle(
    body: Iterable[ast.stmt],
    settlers_by_name: Dict[str, bool],
) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if not isinstance(node, ast.Call):
                continue
            term = _term(node.func)
            if term in _SETTLE_SINKS:
                return True
            if term is not None and settlers_by_name.get(term):
                return True
    return False


def _exception_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph
) -> List[Finding]:
    settlers = _settler_quals(audits, graph)
    out: List[Finding] = []
    for audit in audits:
        if audit.module.relpath not in ASYNC_CORE_MODULES:
            continue
        mod = audit.module
        # terminal-name view of the settle summary, for resolving the
        # handler body's calls (self-methods and same-module helpers)
        settlers_by_name: Dict[str, bool] = {}
        for fn in audit.functions:
            name = fn.qual.rsplit(".", 1)[-1]
            settlers_by_name[name] = settlers_by_name.get(
                name, False
            ) or (fn.qual in settlers)
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            _walk_handlers(
                fn, mod, settlers_by_name, [], out
            )
    return out


def _walk_handlers(
    fn: ast.AsyncFunctionDef,
    mod: Module,
    settlers_by_name: Dict[str, bool],
    enclosing_finals: List[List[ast.stmt]],
    out: List[Finding],
) -> None:
    def walk(nodes: Iterable[ast.stmt],
             finals: List[List[ast.stmt]]) -> None:
        for stmt in nodes:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if isinstance(stmt, ast.Try):
                inner = finals + (
                    [stmt.finalbody] if stmt.finalbody else []
                )
                walk(stmt.body, inner)
                for handler in stmt.handlers:
                    _judge_handler(
                        fn, mod, handler, settlers_by_name, inner,
                        out,
                    )
                    walk(handler.body, finals)
                walk(stmt.orelse, finals)
                walk(stmt.finalbody, finals)
            else:
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.stmt):
                        walk([child], finals)
                    elif hasattr(child, "body"):
                        pass
                # statements with nested statement lists (if/for/...)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list):
                        walk(
                            [s for s in sub
                             if isinstance(s, ast.stmt)],
                            finals,
                        )

    walk(fn.body, enclosing_finals)


def _judge_handler(
    fn: ast.AsyncFunctionDef,
    mod: Module,
    handler: ast.ExceptHandler,
    settlers_by_name: Dict[str, bool],
    finals: List[List[ast.stmt]],
    out: List[Finding],
) -> None:
    if not _handler_in_scope(handler):
        return
    # propagation: a raise or a loop-retry continue keeps the request
    # alive; forwarding the bound exception (q.put(e),
    # fut.set_exception(e)) hands it to whoever settles
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                break
            if isinstance(node, (ast.Raise, ast.Continue)):
                return
            if (
                handler.name
                and isinstance(node, ast.Call)
                and any(
                    isinstance(a, ast.Name) and a.id == handler.name
                    for a in list(node.args)
                    + [k.value for k in node.keywords]
                )
            ):
                return
    if _calls_settle(handler.body, settlers_by_name):
        return
    if any(
        _calls_settle(final, settlers_by_name) for final in finals
    ):
        return
    if mod.suppressed(EXC_RULE, handler.lineno):
        return
    out.append(_finding(
        mod, EXC_RULE, handler.lineno,
        f"async def {fn.name}: this except exits the request path "
        "without settling or propagating pending entries — the "
        "gather-settles-everything contract (docs/io.md §'The async "
        "core') requires every in-flight future to be resolved or "
        "the exception re-raised/forwarded; settle via "
        "_fail_inflight/set_exception (directly or in a finally), "
        f"or annotate `# ccaudit: allow-{EXC_RULE}(reason)`",
    ))
