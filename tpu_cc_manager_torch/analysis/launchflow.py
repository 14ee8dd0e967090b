"""ccaudit kernel-launch whole-program pass (launchflow).

The port plans on hand-written CUDA kernels, not on jitted programs, so
jitflow's families (they look for ``jax.jit``, ``shard_map`` and donated
arguments) find nothing here. The dispatch contract is the same one:
``plan._DISPATCH_LOCK`` serializes every planner dispatch process-wide,
the planner fetches its outputs through one explicit copy to the host
(``plan._to_host``), and K2 rewrites the resident block in place where
the reference donates it. This pass checks that contract over the same
per-function records, call graph and thread roots, with jitflow's rule
ids, SARIF levels, pragma spellings and hot roots, so a pragma means
the same thing in both packages.

The **launchers** are found from the code: the public functions of
``kernels/`` (``_build.py`` aside, and not the ``*_reference`` plain
versions) whose call-graph closure reaches a ``_build.library()`` call,
the op that hands a kernel to the compiled library. Each carries the
``LAUNCHES`` counters its closure bumps, so a run's launch counts map
onto the inventory. A launcher annotated ``-> None`` writes its first
argument in place.

``host-sync-in-hot-path``
    A value returned by a launcher (or a subscript of one) that flows
    into an implicit device→host copy inside a function reachable from a
    hot root: ``.item()``, ``float()``/``int()``/``bool()``/``list()``,
    ``.tolist()``, ``np.asarray()``, iteration, or a ``.cpu()`` /
    ``.to("cpu")`` that stops at a CPU tensor. Any ``.synchronize()``
    (``torch.cuda.synchronize()``, an event's or a stream's) reachable
    from a hot root fires too: the counterpart of ``.block_until_ready()``.
    The sanctioned fetch is ``.cpu().numpy()`` (or ``.to("cpu").numpy()``)
    at the dispatch boundary, as ``plan._to_host`` does; its result is
    host memory. Values that are host numpy to start with never fire:
    this is provenance, as in jitflow, not name matching. Pragma:
    ``allow-host-sync(reason)``.

``unserialized-dispatch``
    Every call site of a planner launcher outside ``kernels/`` must hold
    ``_DISPATCH_LOCK``, lexically or on every resolved path in
    (``lockset.caller_held_locks``, the ``_locked``-suffix convention).
    The family is every launcher but the device backend's readiness
    probe (``probe_add_one``), which touches no planner state, as the
    reference's ``jaxdev.probe_device`` is no planner dispatch. The
    port's lock covers every planner dispatch, not only the ones that
    span shards: a dispatch launches, and reads back before another may
    touch a resident block. So the reference's public
    ``fleet_tick``, a non-collective jit outside its family, has a
    counterpart here that carries a pragma with its reason instead.
    **error** severity.

``donation-violation``
    A tensor passed as the block to an in-place launcher (``delta_scatter``,
    ``delta_scatter_shards``) and read again by the same function after
    the call, in statement order: the reference's family with "freed"
    read as "rewritten". Rebinding the name ends it. Pragma:
    ``allow-donation(reason)``.

jitflow's ``retrace-hazard`` and ``tracer-leak`` have no counterpart:
nothing in the port is traced. The kernel library compiles once per
process, and the planner caches its dispatch closures on the bucket
ladder. ``simlab/`` and ``analysis/`` are exempt from the host-sync and
donation families, as jitflow and resourceflow exempt them.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from tpu_cc_manager_torch.analysis import callgraph, core, jitflow, lockset
from tpu_cc_manager_torch.analysis import rules, threads
from tpu_cc_manager_torch.analysis.callgraph import CallGraph
from tpu_cc_manager_torch.analysis.core import Finding, Module, resolve_dotted
from tpu_cc_manager_torch.analysis.jitflow import (
    DISPATCH_RULE,
    DONATION_RULE,
    SYNC_RULE,
)
from tpu_cc_manager_torch.analysis.rules import (
    CallRecord,
    FnAudit,
    ModuleAudit,
)
from tpu_cc_manager_torch.analysis.threads import ThreadRoot

#: the three families, in contract order
LAUNCHFLOW_RULES = (SYNC_RULE, DISPATCH_RULE, DONATION_RULE)

#: where the launchers live; ``_build.py`` is the library's builder
KERNELS_PREFIX = "tpu_cc_manager_torch/kernels/"
_BUILD_MODULE = KERNELS_PREFIX + "_build.py"

#: the call that hands a kernel to the compiled library, by its
#: import-folded dotted suffix
_LIBRARY_SUFFIX = "_build.library"

#: the per-kernel launch counters each wrapper bumps where it launches
_COUNTS_NAME = "LAUNCHES"

#: launchers outside the dispatch contract: the device backend's
#: readiness probe launches on a fresh scratch tensor and touches no
#: resident planner block
_NOT_DISPATCH = frozenset({"probe_add_one"})

#: how many modules a launcher's name may pass through by import
_REEXPORT_HOPS = 4

_EXEMPT_PREFIXES = ("tpu_cc_manager_torch/simlab/",
                    "tpu_cc_manager_torch/analysis/")


def _is_exempt(relpath: str) -> bool:
    return relpath.startswith(_EXEMPT_PREFIXES)


# ------------------------------------------------------------ inventory


@dataclass(frozen=True)
class Launcher:
    """One public kernel wrapper that launches a compiled kernel."""

    name: str
    qual: str
    module: str  #: relpath
    line: int
    #: the ``LAUNCHES`` keys its closure bumps
    kernels: Tuple[str, ...]
    #: annotated ``-> None``: it writes its first argument in place
    in_place: bool
    #: name of that first parameter (the block the kernel rewrites)
    block_param: Optional[str]
    #: under the ``_DISPATCH_LOCK`` contract
    dispatch: bool


@dataclass(frozen=True)
class Site:
    """A launch-contract site the pass looked at: a call of a launcher
    outside ``kernels/``, a host sync, or a read after an in-place
    write. ``status`` is ``locked`` (a dispatch under the lock),
    ``pragma`` (suppressed) or ``finding``."""

    rule: str
    file: str
    line: int
    #: the launcher whose call, output or block the site is about ("" for
    #: a ``.synchronize()``)
    launcher: str
    status: str
    #: what the site does (host sync) or the name read (in-place rewrite)
    what: str = ""
    #: the function the site is in
    fn: str = ""
    #: the line of the in-place launch a read follows
    at: int = 0


def _library_callers(audit: ModuleAudit) -> Set[str]:
    out: Set[str] = set()
    for fn in audit.functions:
        if fn.node is None:
            continue
        for node in jitflow._ordered_body(fn.node):
            if isinstance(node, ast.Call):
                resolved = resolve_dotted(node.func, audit.imports) or ""
                if resolved.endswith(_LIBRARY_SUFFIX):
                    out.add(fn.qual)
                    break
    return out


def _count_keys(fn: FnAudit) -> Set[str]:
    """``LAUNCHES["k"] += 1`` keys in one function's own body."""
    keys: Set[str] = set()
    for node in jitflow._ordered_body(fn.node):
        if isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Subscript) and isinstance(
                node.target.value, ast.Name) and \
                node.target.value.id == _COUNTS_NAME and isinstance(
                node.target.slice, ast.Constant) and isinstance(
                node.target.slice.value, str):
            keys.add(node.target.slice.value)
    return keys


def build_inventory(audits: Sequence[ModuleAudit],
                    graph: CallGraph) -> List[Launcher]:
    kernel_audits = [
        a for a in audits
        if a.module.relpath.startswith(KERNELS_PREFIX)
        and a.module.relpath != _BUILD_MODULE
    ]
    sites: Set[str] = set()
    for audit in kernel_audits:
        sites |= _library_callers(audit)
    if not sites:
        return []
    out: List[Launcher] = []
    for audit in kernel_audits:
        for fn in audit.functions:
            if fn.node is None or fn.scope or fn.name.startswith("_") \
                    or fn.name.endswith("_reference"):
                continue
            closure = graph.reachable([fn.qual])
            if not closure & sites:
                continue
            keys: Set[str] = set()
            for q in closure:
                callee = graph.fns.get(q)
                if callee is not None and callee.node is not None and \
                        graph.owner[q].module.relpath.startswith(
                            KERNELS_PREFIX):
                    keys |= _count_keys(callee)
            ret = fn.node.returns
            in_place = isinstance(ret, ast.Constant) and ret.value is None
            out.append(Launcher(
                name=fn.name, qual=fn.qual, module=audit.module.relpath,
                line=fn.line, kernels=tuple(sorted(keys)),
                in_place=in_place,
                block_param=fn.params[0] if in_place and fn.params
                else None,
                dispatch=fn.name not in _NOT_DISPATCH,
            ))
    return sorted(out, key=lambda x: (x.module, x.line))


class _Resolver:
    """Call-site → launcher, through same-module resolution, import
    folding, and re-exports (``plan.fleet_tick_block`` when ``plan``
    imported it)."""

    def __init__(self, audits: Sequence[ModuleAudit],
                 launchers: Sequence[Launcher]):
        self.by_qual = {x.qual: x for x in launchers}
        self.imports = {a.dotted: a.imports for a in audits}

    def dotted(self, path: Optional[str]) -> Optional[Launcher]:
        for _ in range(_REEXPORT_HOPS):
            if not path:
                return None
            hit = self.by_qual.get(path)
            if hit is not None:
                return hit
            mod, _, name = path.rpartition(".")
            path = self.imports.get(mod, {}).get(name)
        return None

    def _qualified(self, audit: ModuleAudit, resolved: Optional[str],
                   bare: Optional[str]) -> Optional[Launcher]:
        if bare is not None and resolved == bare:
            resolved = f"{audit.dotted}.{bare}"
        return self.dotted(resolved)

    def call(self, audit: ModuleAudit, node: ast.Call) -> Optional[Launcher]:
        bare = node.func.id if isinstance(node.func, ast.Name) else None
        return self._qualified(
            audit, resolve_dotted(node.func, audit.imports), bare)

    def record(self, audit: ModuleAudit, c: CallRecord) -> Optional[Launcher]:
        return self._qualified(audit, c.resolved, c.bare)


# ----------------------------------------------------------- entry point


def survey(audits: Sequence[ModuleAudit], graph: CallGraph,
           roots: Dict[str, ThreadRoot]
           ) -> Tuple[List[Launcher], List[Site]]:
    """The launcher inventory and every site the three families looked
    at, with its status."""
    launchers = build_inventory(audits, graph)
    if not launchers:
        return [], []
    res = _Resolver(audits, launchers)
    sites: List[Site] = []
    sites.extend(_host_sync_sites(audits, graph, res))
    sites.extend(_dispatch_sites(audits, graph, roots, res))
    sites.extend(_donation_sites(audits, res))
    return launchers, sorted(set(sites), key=lambda s: (
        s.file, s.line, s.rule, s.launcher))


def survey_paths(root: Optional[str] = None, cache: bool = False
                 ) -> Tuple[List[Launcher], List[Site]]:
    """:func:`survey` over the default surface under ``root`` (the repo
    by default), through the fact cache under ``root`` when ``cache``
    is set, as ``core.analyze_paths`` loads it."""
    root = root or core.repo_root()
    cache_dir = os.path.join(root, core.CACHE_DIR_NAME)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        version = core.analyzer_version_hash()
    audits = []
    for rel in core.iter_python_files(root, core.DEFAULT_TARGETS):
        if cache:
            audit = core.load_audit_cached(root, rel, cache_dir, version)
        else:
            mod = core.load_module(root, rel)
            audit = None if mod is None else rules.audit_module(mod)
        if audit is not None:
            audits.append(audit)
    graph = callgraph.build(audits)
    return survey(audits, graph, threads.infer_roots(audits, graph))


def launchflow_findings(
    audits: Sequence[ModuleAudit],
    graph: CallGraph,
    roots: Dict[str, ThreadRoot],
) -> List[Finding]:
    """Run the three families over already-collected audits."""
    _, sites = survey(audits, graph, roots)
    by_rel = {a.module.relpath: a.module for a in audits}
    out = [
        _finding(by_rel[s.file], s)
        for s in sites if s.status == "finding"
    ]
    return sorted(set(out))


_MESSAGES = {
    SYNC_RULE: (
        "{what} inside `{fn}`, which is on a reconcile/scan hot path — "
        "an implicit device→host sync stalls the controller thread on "
        "the card; fetch once, explicitly, with `.cpu().numpy()` at the "
        "dispatch boundary (plan._to_host)"),
    DISPATCH_RULE: (
        "kernel launcher `{launcher}` dispatched without holding "
        "_DISPATCH_LOCK (plan.py's dispatch contract): a planner "
        "dispatch launches and reads back before another may touch a "
        "resident block, and a sharded tick's partials, peer copies and "
        "combine must not interleave with another thread's; wrap the "
        "call in `with plan._DISPATCH_LOCK:` or route through the "
        "geometry's locked runner"),
    DONATION_RULE: (
        "`{what}` was rewritten in place by `{launcher}` (line {at}) — "
        "this read sees the kernel's writes, not the value the function "
        "held before; read the block after the call on purpose (and say "
        "so with a pragma), or keep a copy"),
}


def _finding(mod: Module, site: Site) -> Finding:
    message = _MESSAGES[site.rule].format(
        what=site.what, launcher=site.launcher, fn=site.fn, at=site.at)
    return Finding(
        file=site.file, line=site.line, rule=site.rule, message=message,
        text=mod.line_text(site.line),
        severity="warning" if site.rule in jitflow.WARNING_RULES
        else "error",
    )


def _site(mod: Module, rule: str, line: int, launcher: str,
          locked: bool = False, **detail) -> Site:
    if locked:
        status = "locked"
    elif jitflow._suppressed(mod, rule, line):
        status = "pragma"
    else:
        status = "finding"
    return Site(rule=rule, file=mod.relpath, line=line, launcher=launcher,
                status=status, **detail)


# ------------------------------------- family 1: host sync in hot path


def _is_cpu_fetch(node: ast.AST) -> bool:
    """``x.cpu()`` or ``x.to("cpu")``."""
    if not isinstance(node, ast.Call) or not isinstance(
            node.func, ast.Attribute):
        return False
    if node.func.attr == "cpu" and not node.args:
        return True
    return node.func.attr == "to" and len(node.args) == 1 and isinstance(
        node.args[0], ast.Constant) and node.args[0].value == "cpu"


def _fetched(node: ast.AST) -> bool:
    """``<...>.cpu().numpy()``: the sanctioned explicit fetch."""
    return isinstance(node, ast.Call) and isinstance(
        node.func, ast.Attribute) and node.func.attr == "numpy" and \
        _is_cpu_fetch(node.func.value)


def _host_sync_sites(audits: Sequence[ModuleAudit], graph: CallGraph,
                     res: _Resolver) -> List[Site]:
    hot = jitflow._hot_set(audits, graph)
    out: List[Site] = []
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath) or mod.relpath.startswith(
                KERNELS_PREFIX):
            continue
        for fn in audit.functions:
            if fn.qual not in hot or fn.node is None:
                continue
            out.extend(_host_syncs_in(audit, fn, res))
    return out


def _host_syncs_in(audit: ModuleAudit, fn: FnAudit,
                   res: _Resolver) -> List[Site]:
    mod = audit.module
    out: List[Site] = []
    #: locals holding a launcher's (device-side) output → its launcher
    dev: Dict[str, str] = {}
    #: ``.cpu()`` calls that a ``.numpy()`` completes
    completed: Set[int] = set()

    def emit(line: int, what: str, launcher: str) -> None:
        out.append(_site(mod, SYNC_RULE, line, launcher, what=what,
                         fn=fn.name))

    def source(expr: ast.AST) -> Optional[str]:
        """The launcher whose raw output ``expr`` is (a local holding
        one, a launcher call, or a subscript of either), else None."""
        while isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Name):
            return dev.get(expr.id)
        if isinstance(expr, ast.Call):
            hit = res.call(audit, expr)
            return hit.name if hit is not None else None
        return None

    for node in jitflow._ordered_body(fn.node):
        if isinstance(node, ast.Assign):
            launcher = source(node.value)
            for tgt in node.targets:
                names = [tgt] if isinstance(tgt, ast.Name) else [
                    e for e in getattr(tgt, "elts", ())
                    if isinstance(e, ast.Name)]
                for name in names:
                    if launcher is not None:
                        dev[name.id] = launcher
                    else:
                        dev.pop(name.id, None)
            continue
        if isinstance(node, ast.For):
            launcher = source(node.iter)
            if launcher is not None:
                emit(node.lineno, "iterating a launcher's output",
                     launcher)
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        resolved = resolve_dotted(func, audit.imports) or ""
        if _fetched(node):
            completed.add(id(func.value))
            continue
        if isinstance(func, ast.Attribute) and func.attr == "synchronize":
            emit(node.lineno, "`.synchronize()` parks the thread until "
                 "the card finishes", "")
            continue
        if _is_cpu_fetch(node) and id(node) not in completed:
            launcher = source(func.value)
            if launcher is not None:
                emit(node.lineno, f"`.{func.attr}()` that stops at a CPU "
                     "tensor, on a launcher's output", launcher)
            continue
        if isinstance(func, ast.Attribute) and func.attr in (
                "item", "tolist"):
            launcher = source(func.value)
            if launcher is not None:
                emit(node.lineno, f"`.{func.attr}()` on a launcher's "
                     "output", launcher)
            continue
        if isinstance(func, ast.Name) and func.id in (
                "float", "int", "bool", "list") and node.args:
            launcher = source(node.args[0])
            if launcher is not None:
                emit(node.lineno, f"`{func.id}()` on a launcher's output",
                     launcher)
            continue
        if resolved.startswith("numpy.") and resolved.rsplit(
                ".", 1)[-1] in ("asarray", "array") and node.args:
            launcher = source(node.args[0])
            if launcher is not None:
                emit(node.lineno, "`np.asarray()` on a launcher's output",
                     launcher)
    return out


# --------------------------------------- family 2: unserialized dispatch


def _dispatch_sites(audits: Sequence[ModuleAudit], graph: CallGraph,
                    roots: Dict[str, ThreadRoot],
                    res: _Resolver) -> List[Site]:
    raw = []
    for audit in audits:
        if audit.module.relpath.startswith(KERNELS_PREFIX):
            continue
        for fn in audit.functions:
            for c in fn.calls:
                hit = res.record(audit, c)
                if hit is not None and hit.dispatch:
                    raw.append((audit, fn, c, hit))
    caller_held: Dict[str, FrozenSet[str]] = {}
    if any(not _holds(c.held_locks) for _, _, c, _ in raw):
        caller_held = lockset.caller_held_locks(audits, graph, roots)
    return [
        _site(audit.module, DISPATCH_RULE, c.line, hit.name,
              locked=_holds(c.held_locks | caller_held.get(
                  fn.qual, frozenset())))
        for audit, fn, c, hit in raw
    ]


def _holds(locks: FrozenSet[str]) -> bool:
    return any(q.rsplit(".", 1)[-1] == jitflow._DISPATCH_LOCK_NAME
               for q in locks)


# ------------------------------------------ family 3: in-place rewrite


def _donation_sites(audits: Sequence[ModuleAudit],
                    res: _Resolver) -> List[Site]:
    in_place = [x for x in res.by_qual.values() if x.in_place]
    if not in_place:
        return []
    names = {x.name for x in in_place}
    out: List[Site] = []
    for audit in audits:
        mod = audit.module
        if _is_exempt(mod.relpath) or mod.relpath.startswith(
                KERNELS_PREFIX) or not any(n in mod.source for n in names):
            continue
        for fn in audit.functions:
            if fn.node is None:
                continue
            #: rewritten name → (line of the call, launcher)
            rewritten: Dict[str, Tuple[int, str]] = {}
            for node in jitflow._ordered_body(fn.node):
                if isinstance(node, ast.Name):
                    hit = rewritten.get(node.id)
                    if hit is None:
                        continue
                    if isinstance(node.ctx, ast.Store):
                        del rewritten[node.id]
                    elif isinstance(node.ctx, ast.Load) \
                            and node.lineno > hit[0]:
                        del rewritten[node.id]
                        out.append(_site(
                            mod, DONATION_RULE, node.lineno, hit[1],
                            what=node.id, at=hit[0]))
                    continue
                if not isinstance(node, ast.Call):
                    continue
                launcher = res.call(audit, node)
                if launcher is None or not launcher.in_place:
                    continue
                block = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords
                     if kw.arg == launcher.block_param), None)
                if isinstance(block, ast.Name):
                    rewritten[block.id] = (node.lineno, launcher.name)
    return out
