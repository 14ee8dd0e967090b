"""ccaudit resource & overload-discipline pass (v6 "resourceflow").

ROADMAP item 3 (overload discipline) starts from an admission the aio
core's own docs make: past the connection budget, writers queue without
bound (docs/io.md). The paper's agent is fail-secure only if every
drain, flip, and publish path degrades *deliberately* under saturation
— and v1–v5 see locks, protocol flows, threads, the event loop and the
JAX dispatch surface, but are blind to the hazard class that dominates
a saturated control plane: unbounded backlogs, blocking calls with no
deadline, retry storms without backoff or jitter, leaked sockets and
executors, and waits a SIGTERM cannot interrupt. This module teaches
the analyzer those disciplines — five rule families over the same
per-function records and call graph the thread/async/jit passes consume
(docs/analysis.md §v6 has the full contract):

``unbounded-queue``
    A ``queue.Queue``/``asyncio.Queue`` family constructor without a
    positive ``maxsize``, a ``queue.SimpleQueue`` (no bound exists), or
    a cross-context ``collections.deque`` (stored to ``self.`` or a
    module global) without ``maxlen``, anywhere on the package surface.
    An unbounded queue turns overload into latency and memory growth
    instead of an honest error; the aio writer backlog was the seeded
    true positive (now bounded behind ``TPU_CC_KUBE_QUEUE`` with
    ``tpu_cc_kube_queue_rejected_total`` accounting). Function-local
    scratch deques are exempt — they cannot outlive one call. **Error**
    severity. Pragma: ``allow-unbounded-queue(reason)``.

``missing-deadline``
    A BOUNDED/UNBOUNDED timeout lattice over the reconcile/scan/flip
    call-graph closure (widened with the aio/batch/client I/O core —
    that IS the reconcile I/O surface): every blocking sink that takes
    a deadline — ``Future.result``, ``concurrent.futures.wait``,
    ``subprocess.run``/``communicate``, ``requests.*``,
    ``select.select``, and awaited stream reads / semaphore acquires /
    queue gets — must receive one on every caller path. Recognizers:
    ``asyncio.wait_for`` wrapping, deadline-clamp arithmetic
    (``max(0.1, deadline - time.monotonic())`` stays BOUNDED through
    ``min``/``max``/``-``), and timeout-*forwarding* parameters, which
    are resolved through a caller-path ⋂-fixpoint: a parameter is
    BOUNDED only if its default is a bounded constant or every resolved
    call site passes a bounded value (transitively through the callers'
    own parameters). Pragma: ``allow-missing-deadline(reason)``.

``retry-discipline``
    A retry loop — a ``for``/``while`` whose ``try`` does I/O and whose
    ``except`` lets the loop go around again — must show all three
    legs: an attempt/deadline **cap** (finite iterator, an
    attempt-counter or deadline compare, or a stop-governed wait),
    **backoff growth** (``*=``/``2 ** n`` shapes, or a call whose
    call-graph closure shows them), and **jitter** (``random.*`` or a
    jitter-named helper, same transitive summary). Any missing leg
    fires, naming the legs. Two-attempt replay loops (``for attempt in
    (0, 1)``) are the exactly-once replay shape, not congestion
    control, and are exempt. Pragma: ``allow-retry-discipline(reason)``.

``resource-leak``
    Path-sensitive acquire/release over sockets, files, executors,
    tempfiles and subprocesses: an acquisition bound to a local must
    reach a close-family sink (``close``/``shutdown``/``cleanup``/
    ``terminate``/``kill``/``aclose``) under ``try/finally``, be used
    as a context manager, or visibly transfer ownership (returned,
    yielded, stored, or passed to another call). A close reachable only
    on the straight-line path — not in a ``finally`` — fires the
    exception-path variant. ``self.``-attribute acquisitions must have
    SOME close site for that attribute in the module. Pragma:
    ``allow-resource-leak(reason)``.

``stop-aware-wait``
    Blocking waits on controller/reconcile threads must ride a
    stop/shutdown-interruptible primitive — the ``_stop``-Event
    convention (``self._stop.wait(t)``, never ``time.sleep(t)``) — so
    SIGTERM never hangs a flip. A wait on a non-stop event needs a
    bounded timeout, and inside a loop the loop must consult the stop
    signal. **Error** severity when the wait sits in a loop (the
    loop-wedging shape); warning otherwise. ``time.sleep``-in-loop
    sites inside the poll-path modules stay owned by the existing
    ``poll-in-watch-path`` rule (no double report). Pragma:
    ``allow-stop-aware-wait(reason)``.

All five ids take ``# ccaudit: allow-<rule>(reason)`` pragmas; the
baseline ratchet, SARIF output and ``--files``/``--cache`` modes treat
them exactly like every earlier family.
"""

from __future__ import annotations

import ast
import re
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

from tpu_cc_manager_torch.analysis.callgraph import CallGraph
from tpu_cc_manager_torch.analysis.core import Finding, Module, resolve_dotted
from tpu_cc_manager_torch.analysis.rules import (
    FnAudit,
    ModuleAudit,
    POLL_PATH_MODULES,
)

QUEUE_RULE = "unbounded-queue"
DEADLINE_RULE = "missing-deadline"
RETRY_RULE = "retry-discipline"
LEAK_RULE = "resource-leak"
STOP_RULE = "stop-aware-wait"

#: every v6 family, in contract order (bench stamps this count so the
#: smoke job can assert the pass actually ran)
RESOURCEFLOW_RULES = (
    QUEUE_RULE, DEADLINE_RULE, RETRY_RULE, LEAK_RULE, STOP_RULE,
)

#: module prefixes exempt from the v6 families: benches and scripts are
#: one-shot CLIs whose backlog is their argv, simlab drives wall-clock
#: scenarios on purpose, and the analyzer itself is a batch tool with
#: no controller thread to wedge.
_EXEMPT_PREFIXES = (
    "bench.py", "scripts/", "tpu_cc_manager_torch/simlab/",
    "tpu_cc_manager_torch/analysis/",
)

#: controller/reconcile-thread modules — the threads SIGTERM must be
#: able to interrupt (the stop-aware-wait surface). The k8s transport
#: and device layers are deliberately absent: their waits are bounded
#: by per-call read timeouts and stop-awareness lives one layer up.
STOP_SURFACE_MODULES = frozenset({
    "tpu_cc_manager_torch/agent.py",
    "tpu_cc_manager_torch/fleet.py",
    "tpu_cc_manager_torch/policy.py",
    "tpu_cc_manager_torch/engine.py",
    "tpu_cc_manager_torch/flipexec.py",
    "tpu_cc_manager_torch/drain.py",
    "tpu_cc_manager_torch/rollout.py",
    "tpu_cc_manager_torch/watch.py",
    "tpu_cc_manager_torch/leader.py",
    "tpu_cc_manager_torch/federation.py",
    "tpu_cc_manager_torch/shard.py",
    "tpu_cc_manager_torch/slice_coord.py",
    "tpu_cc_manager_torch/tsring.py",
    "tpu_cc_manager_torch/fleetobs.py",
    "tpu_cc_manager_torch/webhook.py",
    "tpu_cc_manager_torch/profiler.py",
})

#: the I/O core: every function here is on the reconcile closure by
#: definition — the controllers' blocking calls bottom out in these
#: modules whether or not the nominal call graph can see through an
#: untyped ``kube`` parameter.
IO_CORE_MODULES = frozenset({
    "tpu_cc_manager_torch/k8s/aio.py",
    "tpu_cc_manager_torch/k8s/aio_bridge.py",
    "tpu_cc_manager_torch/k8s/batch.py",
    "tpu_cc_manager_torch/k8s/client.py",
})

#: function names that root the missing-deadline closure: the
#: controllers' reconcile/scan bodies and the flip executor's entry
_DEADLINE_ROOT_NAMES = frozenset({
    "reconcile", "scan_once", "_scan", "run_flips",
})

#: receiver names that carry the stop/shutdown convention — waiting on
#: one of these IS the interruptible wait (``_wake`` qualifies because
#: ``stop()`` pulses it alongside ``_stop``; fleet.py's run loop is the
#: charter example)
_STOP_NAME_RE = re.compile(
    r"(stop|shutdown|halt|quit|exit|term|abort|wake|cancel)", re.I,
)

#: timeout argument names that read as deadline clamps ("how much of my
#: budget is left"), accepted on non-stop waits
_REMAINING_NAME_RE = re.compile(
    r"(remaining|deadline|budget|left|until)", re.I,
)

#: queue-shaped receiver names for blocking ``.get()`` recognition
_QUEUE_NAME_RE = re.compile(r"(queue|mailbox|inbox|_q$|^q$)", re.I)

#: names whose appearance in a loop's compare reads as an attempt or
#: deadline cap
_CAP_NAME_RE = re.compile(
    r"(attempt|tr(y|ies)|retr|count|budget|deadline|until|remaining|"
    r"elapsed|failure)", re.I,
)

#: close-family method names — the transitive release sinks
_CLOSE_ATTRS = frozenset({
    "close", "shutdown", "cleanup", "terminate", "kill", "aclose",
})

#: I/O-verb attribute prefixes for the retry-loop sink gate
_IO_ATTR_PREFIXES = (
    "get_", "list_", "patch_", "replace_", "create_", "delete_",
    "set_", "publish", "flush", "send", "recv", "read", "write",
    "connect", "dial", "request", "_request", "fetch", "watch",
    "relist", "_relist", "put_", "post",
)

#: dotted prefixes that always count as I/O
_IO_DOTTED_PREFIXES = (
    "requests.", "urllib.", "socket.", "subprocess.", "http.",
)

#: acquisition constructors for the resource-leak family, by resolved
#: dotted path or terminal name
_ACQUIRE_RESOLVED = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "tempfile.NamedTemporaryFile": "tempfile",
    "tempfile.TemporaryFile": "tempfile",
    "tempfile.TemporaryDirectory": "tempdir",
    "subprocess.Popen": "subprocess",
}
_ACQUIRE_TERMINALS = {
    "ThreadPoolExecutor": "executor",
    "ProcessPoolExecutor": "executor",
}


def _is_exempt(relpath: str) -> bool:
    return any(
        relpath == p or relpath.startswith(p) for p in _EXEMPT_PREFIXES
    )


def _finding(
    mod: Module, rule: str, line: int, message: str, severity: str,
) -> Finding:
    return Finding(
        file=mod.relpath,
        line=line,
        rule=rule,
        message=message,
        text=mod.line_text(line),
        severity=severity,
    )


def _terminal(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _ordered_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Preorder, source-ordered nodes lexically inside ``fn``, not
    descending into nested defs (a nested def's body runs when *it* is
    called, not where it is defined)."""
    for child in ast.iter_child_nodes(fn):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _ordered_body(child)


def _names_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


# ----------------------------------------------------------- entry point


def resource_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph,
) -> List[Finding]:
    """Run all five v6 families over already-collected audits."""
    findings: List[Finding] = []
    findings.extend(_queue_findings(audits))
    findings.extend(_stop_findings(audits))
    findings.extend(_leak_findings(audits))
    findings.extend(_retry_findings(audits, graph))
    findings.extend(_deadline_findings(audits, graph))
    return sorted(set(findings))


# ----------------------------------------------- family 1: unbounded-queue


def _queue_kind(
    call: ast.Call, imports: Dict[str, str],
) -> Optional[str]:
    """Classify a constructor call: "queue" (maxsize semantics),
    "simple" (never boundable), or "deque" (maxlen semantics)."""
    resolved = resolve_dotted(call.func, imports) or ""
    if resolved == "queue.SimpleQueue":
        return "simple"
    if resolved in (
        "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
        "asyncio.Queue", "asyncio.LifoQueue", "asyncio.PriorityQueue",
        "multiprocessing.Queue",
    ):
        return "queue"
    if resolved == "collections.deque":
        return "deque"
    return None


def _queue_is_bounded(call: ast.Call, kind: str) -> bool:
    if kind == "simple":
        return False
    if kind == "deque":
        # deque(iterable, maxlen) — the bound is the SECOND positional
        # or the maxlen keyword, and an explicit None is no bound
        if len(call.args) >= 2:
            return True
        for kw in call.keywords:
            if kw.arg == "maxlen":
                return not (isinstance(kw.value, ast.Constant)
                            and kw.value.value is None)
        return False
    # Queue family: maxsize is the first positional or keyword;
    # missing, zero, negative, or None all mean unbounded
    bound: Optional[ast.AST] = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "maxsize":
            bound = kw.value
    if bound is None:
        return False
    if isinstance(bound, ast.Constant):
        return isinstance(bound.value, (int, float)) and bound.value > 0
    return True  # a computed bound is a bound


def _queue_findings(audits: Sequence[ModuleAudit]) -> List[Finding]:
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        if "Queue" not in mod.source and "deque" not in mod.source:
            continue
        _scan_queue_stmts(mod, audit.imports, mod.tree.body, "module", out)
    return out


def _scan_queue_stmts(
    mod: Module, imports: Dict[str, str], stmts: Sequence[ast.stmt],
    ctx: str, out: List[Finding],
) -> None:
    """Recursive statement walk tracking the binding context: "module"
    and "class" bindings (and any ``self.``-attribute store) are
    cross-context containers; a bare local deque is scratch."""
    for stmt in stmts:
        if isinstance(stmt, ast.ClassDef):
            _scan_queue_stmts(mod, imports, stmt.body, "class", out)
            continue
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _scan_queue_stmts(mod, imports, stmt.body, "fn", out)
            continue
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                _scan_queue_stmts(mod, imports, [child], ctx, out)
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        for call in [
            n for n in ast.walk(stmt) if isinstance(n, ast.Call)
        ]:
            kind = _queue_kind(call, imports)
            if kind is None or _queue_is_bounded(call, kind):
                continue
            if kind == "deque":
                # only cross-context deques: stored to self./a class or
                # module binding. Function-local scratch is exempt.
                value_of_stmt = getattr(stmt, "value", None)
                cross = value_of_stmt is call and (
                    any(isinstance(t, ast.Attribute) for t in targets)
                    or (ctx in ("module", "class")
                        and any(isinstance(t, ast.Name) for t in targets))
                )
                if not cross:
                    continue
            if mod.suppressed(QUEUE_RULE, call.lineno):
                continue
            what = ("queue.SimpleQueue has no bound at all — use "
                    "queue.Queue(maxsize=...)" if kind == "simple" else
                    "no maxlen" if kind == "deque" else
                    "no positive maxsize")
            out.append(_finding(
                mod, QUEUE_RULE, call.lineno,
                f"unbounded queue constructed here ({what}): under "
                "overload this backlog grows without limit, turning "
                "saturation into memory growth and unbounded latency "
                "instead of an honest rejection — bound it (the aio "
                "writer backlog rides TPU_CC_KUBE_QUEUE with "
                "tpu_cc_kube_queue_rejected_total accounting) or carry "
                "allow-unbounded-queue(reason)",
                severity="error",
            ))
        # recurse into compound statements (loops/ifs/try/with bodies)
        for body_attr in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, body_attr, None)
            if not sub:
                continue
            if body_attr == "handlers":
                for h in sub:
                    _scan_queue_stmts(mod, imports, h.body, ctx, out)
            elif isinstance(sub, list) and sub and isinstance(
                    sub[0], ast.stmt):
                _scan_queue_stmts(mod, imports, sub, ctx, out)


# --------------------------------------------- family 5: stop-aware-wait


@dataclass
class _WaitCtx:
    in_loop: bool = False
    #: While tests of every enclosing loop (stop checks live there)
    loop_tests: Tuple[ast.AST, ...] = ()


def _stop_findings(audits: Sequence[ModuleAudit]) -> List[Finding]:
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        if mod.relpath not in STOP_SURFACE_MODULES:
            continue
        for fn in audit.functions:
            if fn.node is None or fn.is_async:
                continue
            _walk_stop(mod, audit.imports, fn.node, _WaitCtx(), out)
    return out


def _loops_consult_stop(ctx: _WaitCtx) -> bool:
    return any(
        any(_STOP_NAME_RE.search(n) for n in _names_in(t))
        for t in ctx.loop_tests
    )


def _walk_stop(
    mod: Module, imports: Dict[str, str], node: ast.AST, ctx: _WaitCtx,
    out: List[Finding],
) -> None:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        if isinstance(child, ast.While):
            sub = _WaitCtx(True, ctx.loop_tests + (child.test,))
        elif isinstance(child, ast.For):
            sub = _WaitCtx(True, ctx.loop_tests)
        else:
            sub = ctx
        if isinstance(child, ast.Call):
            _check_wait_call(mod, imports, child, ctx, out)
        _walk_stop(mod, imports, child, sub, out)


def _check_wait_call(
    mod: Module, imports: Dict[str, str], call: ast.Call, ctx: _WaitCtx,
    out: List[Finding],
) -> None:
    severity = "error" if ctx.in_loop else "warning"
    resolved = resolve_dotted(call.func, imports) or ""
    line = call.lineno
    if resolved == "time.sleep":
        if ctx.in_loop and mod.relpath in POLL_PATH_MODULES:
            return  # owned by poll-in-watch-path (no double report)
        if mod.suppressed(STOP_RULE, line):
            return
        out.append(_finding(
            mod, STOP_RULE, line,
            "time.sleep on a controller thread is not stop-"
            "interruptible: SIGTERM waits out the full sleep"
            + (" on every loop turn" if ctx.in_loop else "")
            + " — ride the stop event (`self._stop.wait(t)` returns "
            "early on shutdown) or carry "
            "allow-stop-aware-wait(reason)",
            severity=severity,
        ))
        return
    if not isinstance(call.func, ast.Attribute):
        return
    attr = call.func.attr
    recv = _terminal(call.func.value) or ""
    if attr == "wait":
        if _STOP_NAME_RE.search(recv):
            return  # the convention itself
        timeout: Optional[ast.AST] = (
            call.args[0] if call.args else None
        )
        for kw in call.keywords:
            if kw.arg == "timeout":
                timeout = kw.value
        if timeout is None or (isinstance(timeout, ast.Constant)
                               and timeout.value is None):
            if mod.suppressed(STOP_RULE, line):
                return
            out.append(_finding(
                mod, STOP_RULE, line,
                f"`{recv}.wait()` with no timeout on a controller "
                "thread: nothing interrupts it on shutdown — wait on "
                "the stop event, or give it a timeout inside a "
                "stop-checking loop",
                severity=severity,
            ))
            return
        if ctx.in_loop and not _loops_consult_stop(ctx):
            t_names = _names_in(timeout)
            if any(_REMAINING_NAME_RE.search(n) for n in t_names):
                return  # deadline-clamped wait: bounded overall
            if mod.suppressed(STOP_RULE, line):
                return
            out.append(_finding(
                mod, STOP_RULE, line,
                f"loop waits on `{recv}` without consulting the stop "
                "signal: each turn re-arms the wait, so SIGTERM never "
                "lands — gate the loop on `self._stop.is_set()` (or "
                "wait on the stop event directly)",
                severity="error",
            ))
        return
    if attr == "get" and not call.args and _QUEUE_NAME_RE.search(recv):
        if any(kw.arg == "timeout" for kw in call.keywords):
            return
        if mod.suppressed(STOP_RULE, line):
            return
        out.append(_finding(
            mod, STOP_RULE, line,
            f"blocking `{recv}.get()` with no timeout on a controller "
            "thread: an empty queue parks it past any shutdown — use "
            "`get(timeout=...)` in a stop-checking loop",
            severity=severity,
        ))


# ------------------------------------------------ family 4: resource-leak


@dataclass
class _Acquisition:
    name: str
    kind: str
    line: int


def _acquire_kind(
    call: ast.Call, imports: Dict[str, str],
) -> Optional[str]:
    resolved = resolve_dotted(call.func, imports)
    if resolved in _ACQUIRE_RESOLVED:
        return _ACQUIRE_RESOLVED[resolved]
    term = _terminal(call.func)
    if term in _ACQUIRE_TERMINALS:
        return _ACQUIRE_TERMINALS[term]
    if isinstance(call.func, ast.Name) and call.func.id == "open" \
            and resolved in (None, "open"):
        # the builtin resolves to its own bare name; an import-shadowed
        # `open` (gzip.open…) resolves dotted and is out of scope
        return "file"
    return None


def _leak_findings(audits: Sequence[ModuleAudit]) -> List[Finding]:
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        #: attr name -> acquisition line, for the module-level sweep
        attr_acquires: List[Tuple[str, int]] = []
        for fn in audit.functions:
            if fn.node is None:
                continue
            _leak_scan_fn(mod, audit.imports, fn, attr_acquires, out)
        if attr_acquires:
            closed = _module_closed_attrs(mod)
            for attr, line in attr_acquires:
                if attr in closed or mod.suppressed(LEAK_RULE, line):
                    continue
                out.append(_finding(
                    mod, LEAK_RULE, line,
                    f"`self.{attr}` acquires a resource but nothing in "
                    "this module ever closes it (no close/shutdown/"
                    "cleanup call on that attribute): the handle "
                    "outlives every shutdown path — release it in the "
                    "owner's stop()/close(), or carry "
                    "allow-resource-leak(reason)",
                    severity="warning",
                ))
    return out


def _module_closed_attrs(mod: Module) -> Set[str]:
    """Attribute names that SOME site in the module closes or manages:
    ``self.x.close()``, ``with self.x``, or a pure aliasing assignment
    (``pool, self.x = self.x, None`` — the swap-out-then-shutdown
    idiom) that visibly hands the handle to managing code."""
    closed: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) \
                and node.func.attr in _CLOSE_ATTRS \
                and isinstance(node.func.value, ast.Attribute):
            closed.add(node.func.value.attr)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Attribute):
                    closed.add(ce.attr)
        elif isinstance(node, ast.Assign):
            vals = (list(node.value.elts)
                    if isinstance(node.value, ast.Tuple)
                    else [node.value])
            if all(isinstance(v, (ast.Attribute, ast.Name, ast.Constant))
                   for v in vals):
                for v in vals:
                    if isinstance(v, ast.Attribute):
                        closed.add(v.attr)
    return closed


def _leak_scan_fn(
    mod: Module, imports: Dict[str, str], fn: FnAudit,
    attr_acquires: List[Tuple[str, int]], out: List[Finding],
) -> None:
    acquisitions: List[_Acquisition] = []
    for node in _ordered_body(fn.node):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        if not isinstance(node.value, ast.Call):
            continue
        kind = _acquire_kind(node.value, imports)
        if kind is None:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name):
            acquisitions.append(
                _Acquisition(tgt.id, kind, node.lineno))
        elif isinstance(tgt, ast.Attribute):
            attr_acquires.append((tgt.attr, node.lineno))
    for acq in acquisitions:
        verdict = _local_release_verdict(fn.node, acq)
        if verdict is None or mod.suppressed(LEAK_RULE, acq.line):
            continue
        if verdict == "never":
            msg = (
                f"`{acq.name}` acquires a {acq.kind} that is never "
                "released on any path: wrap it in `with`, or close it "
                "in a try/finally"
            )
        else:
            msg = (
                f"`{acq.name}` ({acq.kind}) is closed only on the "
                "straight-line path — an exception between acquire and "
                "close leaks the handle; move the close into a "
                "`finally` or use a context manager"
            )
        out.append(_finding(mod, LEAK_RULE, acq.line, msg,
                            severity="warning"))


def _local_release_verdict(
    fn_node: ast.AST, acq: _Acquisition,
) -> Optional[str]:
    """None = released/transferred; "never" / "success-only"."""
    name = acq.name
    close_in_finally = False
    close_anywhere = False

    def walk(node: ast.AST, in_finally: bool) -> Optional[bool]:
        nonlocal close_in_finally, close_anywhere
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                # a nested def capturing the handle = escape
                if name in {
                    n.id for n in ast.walk(child)
                    if isinstance(n, ast.Name)
                }:
                    return True
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                for item in child.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Name) and ce.id == name:
                        return True
            if isinstance(child, (ast.Return, ast.Yield, ast.YieldFrom)) \
                    and child.value is not None and name in {
                        n.id for n in ast.walk(child.value)
                        if isinstance(n, ast.Name)
                    }:
                return True
            if isinstance(child, ast.Assign) and getattr(
                    child, "lineno", 0) > acq.line and name in {
                        n.id for n in ast.walk(child.value)
                        if isinstance(n, ast.Name)
                    }:
                return True  # aliased/stored — ownership transferred
            if isinstance(child, ast.Call):
                f = child.func
                if isinstance(f, ast.Attribute) and isinstance(
                        f.value, ast.Name) and f.value.id == name:
                    if f.attr in _CLOSE_ATTRS:
                        close_anywhere = True
                        if in_finally:
                            close_in_finally = True
                        continue
                else:
                    # the handle passed as an argument = transfer
                    for sub in list(child.args) + [
                        kw.value for kw in child.keywords
                    ]:
                        if any(
                            isinstance(n, ast.Name) and n.id == name
                            for n in ast.walk(sub)
                        ):
                            return True
            if isinstance(child, ast.Try):
                for part in (child.body, child.orelse):
                    for stmt in part:
                        if walk_one(stmt, in_finally):
                            return True
                for h in child.handlers:
                    for stmt in h.body:
                        if walk_one(stmt, in_finally):
                            return True
                for stmt in child.finalbody:
                    if walk_one(stmt, True):
                        return True
                continue
            if walk(child, in_finally):
                return True
        return False

    def walk_one(stmt: ast.AST, in_finally: bool) -> Optional[bool]:
        # apply the same checks to `stmt` itself, then its children
        class _Box(ast.AST):
            _fields = ("x",)
        box = _Box()
        box.x = stmt  # type: ignore[attr-defined]
        return walk(box, in_finally)

    if walk(fn_node, False):
        return None
    if close_in_finally:
        return None
    if close_anywhere:
        return "success-only"
    return "never"


# --------------------------------------------- family 3: retry-discipline


def _retry_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph,
) -> List[Finding]:
    by_qual = {
        fn.qual: (audit, fn)
        for audit in audits for fn in audit.functions
    }
    #: lexical per-function discipline evidence, for the transitive
    #: helper summaries (`jittered_backoff` provides both legs to every
    #: loop whose closure reaches it)
    lexical: Dict[str, Set[str]] = {}
    for audit in audits:
        for fn in audit.functions:
            if fn.node is None:
                continue
            ev: Set[str] = set()
            if "backoff" in fn.name or "jitter" in fn.name:
                ev.add("backoff")
            for node in _ordered_body(fn.node):
                ev |= _leg_evidence(node, audit.imports)
            if ev:
                lexical[fn.qual] = ev
    out: List[Finding] = []
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        for fn in audit.functions:
            if fn.node is None:
                continue
            for loop in _loops_of(fn.node):
                res = _check_retry_loop(
                    mod, audit, fn, loop, lexical, by_qual, graph,
                )
                if res is not None:
                    out.append(res)
    return out


def _loops_of(fn_node: ast.AST) -> List[ast.AST]:
    return [
        n for n in _ordered_body(fn_node)
        if isinstance(n, (ast.For, ast.While))
    ]


def _leg_evidence(node: ast.AST, imports: Dict[str, str]) -> Set[str]:
    """Lexical backoff/jitter evidence contributed by one statement."""
    ev: Set[str] = set()
    if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Mult):
        ev.add("backoff")
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
        ev.add("backoff")
    if isinstance(node, ast.Assign) and isinstance(
            node.targets[0] if node.targets else None, ast.Name):
        tname = node.targets[0].id  # type: ignore[union-attr]
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.BinOp) and isinstance(
                    sub.op, (ast.Mult, ast.Pow)) and tname in {
                        n.id for n in ast.walk(sub)
                        if isinstance(n, ast.Name)
                    }:
                ev.add("backoff")
    if isinstance(node, (ast.Name, ast.Attribute)):
        label = node.id if isinstance(node, ast.Name) else node.attr
        if "jitter" in label.lower():
            ev.add("jitter")
        if "backoff" in label.lower() and isinstance(node, ast.Name):
            pass  # a backoff-NAMED value alone is not growth
    if isinstance(node, ast.Call):
        resolved = resolve_dotted(node.func, imports) or ""
        if resolved.startswith("random."):
            ev.add("jitter")
        term = _terminal(node.func) or ""
        if "jitter" in term.lower():
            ev.add("jitter")
    return ev


def _retry_shape(loop: ast.AST) -> Optional[ast.Try]:
    """The loop's directly-owned retrying Try (its innermost loop is
    ``loop``), or None. A Try retries when some handler neither
    re-raises, returns, nor breaks on its final statement AND the try
    body does I/O."""
    owned: List[ast.Try] = []

    def collect(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.For, ast.While, ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue  # inner loop owns its own tries
            if isinstance(child, ast.Try):
                owned.append(child)
            collect(child)

    collect(loop)
    for t in owned:
        for h in t.handlers:
            if not h.body:
                continue
            last = h.body[-1]
            if isinstance(last, (ast.Raise, ast.Return, ast.Break)):
                continue
            return t
    return None


def _io_in_try(t: ast.Try, imports: Dict[str, str]) -> bool:
    for stmt in t.body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            resolved = resolve_dotted(node.func, imports) or ""
            if resolved.startswith(_IO_DOTTED_PREFIXES):
                return True
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr.startswith(_IO_ATTR_PREFIXES):
                    return True
    return False


def _attempt_iter(it: ast.AST) -> bool:
    """An iterator that counts attempts rather than yielding work
    items: ``range(...)``, a literal sequence, or ``itertools.count``.
    Anything else (a list of nodes, ``/proc`` entries…) makes the loop
    a per-item scan, out of retry-discipline's scope."""
    if isinstance(it, (ast.Tuple, ast.List)):
        return True
    if isinstance(it, ast.Call):
        term = _terminal(it.func)
        return term in ("range", "count", "repeat")
    return False


def _replay_shape(loop: ast.AST) -> bool:
    """``for attempt in (0, 1)`` — the exactly-once replay loop: at
    most two immediate attempts, not congestion control."""
    if not isinstance(loop, ast.For):
        return False
    it = loop.iter
    if isinstance(it, (ast.Tuple, ast.List)) and len(it.elts) <= 2:
        return True
    if isinstance(it, ast.Call) and _terminal(it.func) == "range" \
            and it.args and isinstance(it.args[0], ast.Constant) \
            and isinstance(it.args[0].value, int) \
            and it.args[0].value <= 2 and len(it.args) == 1:
        return True
    return False


def _resolve_simple(
    call: ast.Call, audit: ModuleAudit, fn: FnAudit,
    by_qual: Dict[str, Tuple[ModuleAudit, FnAudit]],
) -> Optional[str]:
    """Nominal call resolution sufficient for discipline summaries:
    bare module/nested names, ``self.m()`` methods, import-folded
    dotted paths."""
    f = call.func
    if isinstance(f, ast.Name):
        for cand in (f"{fn.qual}.{f.id}", f"{audit.dotted}.{f.id}"):
            if cand in by_qual:
                return cand
    resolved = resolve_dotted(f, audit.imports)
    if resolved and resolved in by_qual:
        return resolved
    if isinstance(f, ast.Name):
        return None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self" and fn.class_path:
        cand = ".".join((audit.dotted,) + fn.class_path + (f.attr,))
        if cand in by_qual:
            return cand
    return None


def _check_retry_loop(
    mod: Module, audit: ModuleAudit, fn: FnAudit, loop: ast.AST,
    lexical: Dict[str, Set[str]],
    by_qual: Dict[str, Tuple[ModuleAudit, FnAudit]],
    graph: CallGraph,
) -> Optional[Finding]:
    if isinstance(loop, ast.For) and not _attempt_iter(loop.iter):
        # a for-over-a-collection never re-attempts the same work: an
        # except that moves on is a per-item skip, not a retry
        return None
    t = _retry_shape(loop)
    if t is None or not _io_in_try(t, audit.imports):
        return None
    if _replay_shape(loop):
        return None
    legs: Set[str] = set()
    # cap: any finite For iterator; a While needs a counter/deadline
    # compare or a stop-governed wait
    if isinstance(loop, ast.For):
        legs.add("cap")
    else:
        probes: List[ast.AST] = [loop.test] + list(loop.body)
        for probe in probes:
            for node in ast.walk(probe):
                if isinstance(node, ast.Compare) and any(
                    _CAP_NAME_RE.search(n) for n in _names_in(node)
                ):
                    legs.add("cap")
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr in ("wait", "is_set") \
                        and _STOP_NAME_RE.search(
                            _terminal(node.func.value) or ""):
                    legs.add("cap")  # stop-governed: the owner bounds it
        if any(_STOP_NAME_RE.search(n) for n in _names_in(loop.test)):
            legs.add("cap")
    # backoff + jitter: lexical in the loop, or via a called helper
    # whose call-graph closure shows the evidence
    body_nodes = list(ast.walk(loop))
    for node in body_nodes:
        legs |= _leg_evidence(node, audit.imports)
        if isinstance(node, ast.Call):
            qual = _resolve_simple(node, audit, fn, by_qual)
            if qual is not None:
                for q in {qual} | graph.reachable({qual}):
                    legs |= lexical.get(q, set())
    missing = [leg for leg in ("cap", "backoff", "jitter")
               if leg not in legs]
    if not missing:
        return None
    if mod.suppressed(RETRY_RULE, loop.lineno):
        return None
    names = {
        "cap": "an attempt/deadline cap",
        "backoff": "backoff growth",
        "jitter": "jitter",
    }
    return _finding(
        mod, RETRY_RULE, loop.lineno,
        "retry loop around an I/O sink is missing "
        + " and ".join(names[m] for m in missing)
        + ": uncapped immediate retries synchronize into a thundering "
        "herd exactly when the server is least able to absorb one — "
        "grow the pause per failure, randomize it, and bound the "
        "attempts (or ride a stop-governed wait)",
        severity="warning",
    )


# -------------------------------------------- family 2: missing-deadline


#: boundedness lattice values: BOUNDED / UNBOUNDED / parameter-deps
_B = "B"
_U = "U"

_Bound = Tuple[str, FrozenSet[str]]  # (kind, param deps)

_BOUNDED: _Bound = (_B, frozenset())
_UNBOUNDED: _Bound = (_U, frozenset())

#: calls that read the clock (an operand of a deadline clamp, never a
#: bound by itself)
_CLOCK_CALLS = frozenset({
    "time.monotonic", "time.time", "time.perf_counter",
})


def _combine_any(parts: List[_Bound]) -> _Bound:
    """min/max/arith clamp semantics: one bounded operand bounds the
    whole expression."""
    if any(p[0] == _B and not p[1] for p in parts):
        return _BOUNDED
    deps = frozenset().union(*(p[1] for p in parts)) if parts \
        else frozenset()
    if deps:
        return (_B, deps)
    return _UNBOUNDED


def _classify_bound(
    expr: Optional[ast.AST], env: Dict[str, _Bound],
    params: Sequence[str], imports: Dict[str, str],
) -> _Bound:
    if expr is None:
        return _UNBOUNDED
    if isinstance(expr, ast.Constant):
        if expr.value is None:
            return _UNBOUNDED
        if isinstance(expr.value, (int, float)):
            return _BOUNDED
        return _BOUNDED
    if isinstance(expr, ast.Name):
        if expr.id in env:
            return env[expr.id]
        if expr.id in params:
            return (_B, frozenset({expr.id}))
        return _BOUNDED  # module constant / imported knob: optimistic
    if isinstance(expr, ast.Attribute):
        return _BOUNDED  # config attributes (self.timeout_s) trusted
    if isinstance(expr, ast.Call):
        resolved = resolve_dotted(expr.func, imports) or ""
        if resolved in _CLOCK_CALLS:
            return _UNBOUNDED
        term = _terminal(expr.func)
        if term in ("min", "max") and expr.args:
            return _combine_any([
                _classify_bound(a, env, params, imports)
                for a in expr.args
            ])
        return _BOUNDED
    if isinstance(expr, ast.BinOp):
        return _combine_any([
            _classify_bound(expr.left, env, params, imports),
            _classify_bound(expr.right, env, params, imports),
        ])
    if isinstance(expr, ast.UnaryOp):
        return _classify_bound(expr.operand, env, params, imports)
    if isinstance(expr, ast.IfExp):
        return _combine_any([
            _classify_bound(expr.body, env, params, imports),
            _classify_bound(expr.orelse, env, params, imports),
        ])
    return _BOUNDED


@dataclass
class _Sink:
    mod: Module
    fn: FnAudit
    line: int
    what: str
    bound: _Bound


@dataclass
class _ParamFacts:
    """Per-(function, parameter) boundedness material for the
    caller-path ⋂-fixpoint."""

    default: Optional[_Bound] = None  #: None = parameter has no default
    #: classifications of the argument at every resolved call site
    #: (omitted-argument sites contribute the default)
    sites: List[_Bound] = field(default_factory=list)


def _deadline_findings(
    audits: Sequence[ModuleAudit], graph: CallGraph,
) -> List[Finding]:
    by_qual: Dict[str, Tuple[ModuleAudit, FnAudit]] = {
        fn.qual: (audit, fn)
        for audit in audits for fn in audit.functions
        if fn.node is not None
    }
    closure = _deadline_closure(audits, graph)
    if not closure:
        return []
    sinks: List[_Sink] = []
    facts: Dict[Tuple[str, str], _ParamFacts] = {}
    # one walk per function: collect sinks (closure members only) and
    # call-site argument classifications (every non-exempt module — a
    # caller outside the closure still decides a parameter's bound)
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        for fn in audit.functions:
            if fn.node is None:
                continue
            _walk_deadline_fn(
                mod, audit, fn, fn.qual in closure, by_qual, sinks,
                facts,
            )
    unbounded = _param_fixpoint(facts, graph.depth)
    out: List[Finding] = []
    for s in sinks:
        kind, deps = s.bound
        bad_deps = sorted(d for d in deps if (s.fn.qual, d) in unbounded)
        if kind == _B and not bad_deps and not deps:
            continue
        if deps and not bad_deps:
            continue
        if s.mod.suppressed(DEADLINE_RULE, s.line):
            continue
        if bad_deps:
            msg = (
                f"{s.what} rides parameter `{bad_deps[0]}`, which is "
                "unbounded on at least one caller path (an explicit "
                "None, an unbounded forwarded parameter, or a "
                "None default with no bounded caller): thread a real "
                "deadline through every path, or clamp it at this "
                "boundary"
            )
        else:
            msg = (
                f"{s.what} has no timeout/deadline on a reconcile-path "
                "closure: under a wedged peer this blocks forever and "
                "the drain→flip→verify loop stalls with it — pass a "
                "timeout, wrap the await in asyncio.wait_for, or carry "
                "allow-missing-deadline(reason)"
            )
        out.append(_finding(s.mod, DEADLINE_RULE, s.line, msg,
                            severity="warning"))
    return out


def _deadline_closure(
    audits: Sequence[ModuleAudit], graph: CallGraph,
) -> Set[str]:
    roots: Set[str] = set()
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath):
            continue
        for fn in audit.functions:
            if fn.node is None:
                continue
            if fn.name in _DEADLINE_ROOT_NAMES \
                    or mod.relpath in IO_CORE_MODULES:
                roots.add(fn.qual)
    if not roots:
        return roots
    closure = graph.reachable(roots) | roots
    # widen with nested defs of closure members (a worker closure runs
    # inside its parent's flip even without a nominal edge)
    all_quals = [
        fn.qual for audit in audits for fn in audit.functions
    ]
    while True:
        grown = set(closure)
        for q in all_quals:
            if q in grown:
                continue
            parent = q.rsplit(".", 1)[0]
            if parent in grown:
                grown.add(q)
        if grown == closure:
            return closure
        closure = grown


def _timeout_kw(call: ast.Call, name: str = "timeout") -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _sync_sink(
    call: ast.Call, imports: Dict[str, str],
) -> Optional[Tuple[str, Optional[ast.AST], bool]]:
    """(description, timeout expr or None, timeout_required) for the
    synchronous blocking sinks."""
    resolved = resolve_dotted(call.func, imports) or ""
    if resolved in ("subprocess.run", "subprocess.call",
                    "subprocess.check_call", "subprocess.check_output"):
        return (f"`{resolved}`", _timeout_kw(call), True)
    if resolved.startswith("requests."):
        return (f"`{resolved}`", _timeout_kw(call), True)
    if resolved == "select.select":
        expr = call.args[3] if len(call.args) > 3 else None
        return ("`select.select`", expr, True)
    if resolved.endswith("futures.wait") or resolved == "concurrent.futures.wait":
        return ("`concurrent.futures.wait`", _timeout_kw(call), True)
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr == "result":
            expr = call.args[0] if call.args else _timeout_kw(call)
            recv = _terminal(call.func.value) or "future"
            return (f"`{recv}.result()`", expr, True)
        if attr == "communicate":
            return ("`.communicate()`", _timeout_kw(call), True)
    return None


#: awaited attribute calls that park the coroutine until a peer acts
_ASYNC_SINK_ATTRS = frozenset({
    "read", "readline", "readexactly", "readuntil", "drain",
    "acquire", "get", "join", "wait",
})


def _walk_deadline_fn(
    mod: Module, audit: ModuleAudit, fn: FnAudit, in_closure: bool,
    by_qual: Dict[str, Tuple[ModuleAudit, FnAudit]],
    sinks: List[_Sink],
    facts: Dict[Tuple[str, str], _ParamFacts],
) -> None:
    env: Dict[str, _Bound] = {}
    params = [p for p in fn.params if p not in ("self", "cls")]
    #: await expressions already accounted via a wait_for wrapper
    wrapped: Set[int] = set()
    for node in _ordered_body(fn.node):
        if isinstance(node, ast.Assign):
            val = _classify_bound(node.value, env, params, audit.imports)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = val
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            env[node.target.id] = _classify_bound(
                node.value, env, params, audit.imports)
        if isinstance(node, ast.Await):
            inner = node.value
            if not isinstance(inner, ast.Call):
                continue
            resolved = resolve_dotted(inner.func, audit.imports) or ""
            if resolved.endswith("wait_for"):
                for sub in ast.walk(inner):
                    wrapped.add(id(sub))
                if in_closure:
                    expr = (inner.args[1] if len(inner.args) > 1
                            else _timeout_kw(inner))
                    sinks.append(_Sink(
                        mod, fn, inner.lineno, "`asyncio.wait_for`",
                        _classify_bound(expr, env, params,
                                        audit.imports),
                    ))
                continue
            if id(inner) in wrapped or not in_closure:
                continue
            desc: Optional[str] = None
            if resolved == "asyncio.open_connection":
                desc = "awaited `asyncio.open_connection`"
            elif isinstance(inner.func, ast.Attribute) \
                    and inner.func.attr in _ASYNC_SINK_ATTRS:
                recv = _terminal(inner.func.value) or ""
                if inner.func.attr == "wait" and _STOP_NAME_RE.search(
                        recv):
                    continue  # stop-governed wait: bounded by shutdown
                if inner.func.attr in ("read", "get") and inner.args:
                    # read(n) on a non-stream / get(key) on a mapping
                    # still block, but args suggest non-timeout
                    # semantics only for dict-get; keep streams
                    if inner.func.attr == "get":
                        continue
                desc = f"awaited `{recv}.{inner.func.attr}()`"
            if desc is not None and not _timeout_kw(inner):
                sinks.append(_Sink(mod, fn, inner.lineno, desc,
                                   _UNBOUNDED))
            continue
        if not isinstance(node, ast.Call) or id(node) in wrapped:
            continue
        if in_closure and not fn.is_async:
            hit = _sync_sink(node, audit.imports)
            if hit is not None:
                what, expr, _required = hit
                sinks.append(_Sink(
                    mod, fn, node.lineno, what,
                    _classify_bound(expr, env, params, audit.imports)
                    if expr is not None else _UNBOUNDED,
                ))
        # call-site argument classification for the ⋂-fixpoint
        callee = _resolve_simple(node, audit, fn, by_qual)
        if callee is None:
            continue
        c_audit, c_fn = by_qual[callee]
        c_params = list(c_fn.params)
        offset = 0
        if c_params and c_params[0] in ("self", "cls") \
                and isinstance(node.func, ast.Attribute):
            offset = 1
        defaults = _param_defaults(c_fn)
        supplied: Set[str] = set()
        for i, arg in enumerate(node.args):
            pi = i + offset
            if pi >= len(c_params):
                break
            p = c_params[pi]
            supplied.add(p)
            facts.setdefault((callee, p), _ParamFacts(
                default=defaults.get(p),
            )).sites.append(_classify_bound(
                arg, env, params, audit.imports))
        for kw in node.keywords:
            if kw.arg is None or kw.arg not in c_params:
                continue
            supplied.add(kw.arg)
            facts.setdefault((callee, kw.arg), _ParamFacts(
                default=defaults.get(kw.arg),
            )).sites.append(_classify_bound(
                kw.value, env, params, audit.imports))
        for p in c_params:
            if p in ("self", "cls") or p in supplied:
                continue
            d = defaults.get(p)
            if d is None:
                continue  # missing required arg — not our problem
            facts.setdefault((callee, p), _ParamFacts(
                default=d,
            )).sites.append(d)


def _param_defaults(fn: FnAudit) -> Dict[str, _Bound]:
    """Classification of each defaulted parameter's default value."""
    out: Dict[str, _Bound] = {}
    args = fn.node.args
    pos = args.args
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        out[a.arg] = _classify_bound(d, {}, [], {})
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is not None:
            out[a.arg] = _classify_bound(d, {}, [], {})
    return out


def _param_fixpoint(
    facts: Dict[Tuple[str, str], _ParamFacts], depth: int,
) -> Set[Tuple[str, str]]:
    """Greatest-fixpoint ⋂ over caller paths: a (function, parameter)
    is UNBOUNDED when any resolved call site passes an unbounded value
    (transitively through the caller's own parameters), or when it has
    no resolved sites and its default is unbounded."""
    unbounded: Set[Tuple[str, str]] = set()

    def site_ok(qual: str, b: _Bound) -> bool:
        kind, deps = b
        if kind == _U and not deps:
            return False
        return all((qual, d) not in unbounded for d in deps)

    for _ in range(max(2, depth)):
        changed = False
        for (qual, p), pf in facts.items():
            if (qual, p) in unbounded:
                continue
            bad = False
            if not pf.sites:
                bad = pf.default is not None and pf.default == _UNBOUNDED
            else:
                bad = not all(site_ok(qual, b) for b in pf.sites)
            if bad:
                unbounded.add((qual, p))
                changed = True
        if not changed:
            break
    return unbounded
