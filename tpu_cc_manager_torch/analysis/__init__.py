"""ccaudit — project-specific static analysis for the threaded reconciler fleet.

The reference repo's CI leaned on golangci-lint plus a vacuously green
``go test ./...`` (SURVEY.md §4); our ``make lint`` was a bare
``compileall``. Meanwhile simlab made this a genuinely concurrent system
(shared watch pump, bounded worker pool, leader flaps), and the defect
classes that fleet-scale scenarios hit first — ABBA deadlocks, silent
exception swallows, blocking calls under a lock — are exactly the ones a
compiler can't see but an AST walk can.

ccaudit is that walk. The rules (docs/analysis.md has the full contract):

``raw-acquire``
    Locks are acquired via ``with``; a bare ``.acquire()`` is flagged
    unless a ``try/finally`` in the same function releases the same lock.
``lock-order``
    A global lock-order graph is built from nested ``with`` blocks plus
    **transitive call summaries over the whole-program call graph**
    (``callgraph.py``, v3): a call made while a lock is held orders that
    lock ahead of every lock the callee's closure acquires, across
    modules and up to the depth bound (``--call-depth`` overrides); any
    cycle (a potential ABBA deadlock) is reported.
``blocking-under-lock``
    ``time.sleep``, subprocess, socket/HTTP, and executor waits inside a
    lock's ``with`` body are flagged — lexically, and (v3) transitively
    at any call under the lock whose closure reaches a blocking site.
``label-literal``
    Hard-coded ``tpu.google.com/...`` protocol strings belong in
    ``labels.py`` only; everywhere else must import the constant.
``swallow``
    ``except Exception``/``BaseException``/bare ``except`` bodies must
    re-raise, log, or use the bound exception — or carry an explicit
    ``# ccaudit: allow-swallow(reason)`` pragma.
``metric-name``
    Every metric name has exactly one Counter/Gauge/Histogram/
    HistogramVec declaration; ``tpu_cc_*`` string literals used anywhere
    else must match a declared name (two differently-bucketed
    expositions under one name would corrupt aggregation — obs.py's
    ``kube_throttle_wait_histogram`` docstring is the founding charter).

v2 grew the lexical walker into a flow-sensitive protocol analyzer
(``dataflow.py`` is the reusable core, ``manifests.py`` the non-AST
pass — docs/analysis.md §v2):

``protocol-literal``
    Raw mode/state strings (``"on"``/``"off"``/``"devtools"``/``"ici"``/
    ``"failed"``) flowing into label/annotation write APIs must come from
    ``modes.py``/``labels.py`` constants — tracked through local
    assignment and (v3) transitive cross-module sink summaries over the
    call graph, with the old same-module terminal-name match kept as the
    fallback for unresolvable receivers.
``unvalidated-mode``
    A mode-label value read off a k8s object dict must pass through
    ``parse_mode`` before reaching engine/subprocess/device-call sinks.
``mode-exhaustive``
    ``if``/``elif`` chains and dict dispatches over ``Mode`` must cover
    every member or end in an else that raises.
``protocol-liveness``
    Every key-shaped constant ``labels.py`` exports needs at least one
    writer and one reader across the tree (externally-written keys are
    pragma-annotated).
``manifest-drift``
    ``deployments/**`` and ``scenarios/*.json`` must speak exactly the
    protocol ``labels.py``/``modes.py`` export — unknown keys, unknown
    modes, and a CRD mode enum differing from ``VALID_MODES`` all fail.

v3 made the analyzer whole-program: ``callgraph.py`` (nominal
project-wide call graph — module attributes, ``self.``-methods, nested
defs, typed locals; cycle-safe, depth-bounded by
``callgraph.DEPTH_LIMIT`` with ``--call-depth`` as the escape hatch)
replaces every "one hop, same module" summary, and two new passes ride
on it (docs/analysis.md §v3):

``race-lockset``
    ``threads.py`` infers thread roots (``threading.Thread`` targets,
    executor ``submit`` callables incl. the flipexec worker,
    ``*RequestHandler`` ``do_*`` methods, parameter-linked callbacks);
    ``lockset.py`` runs an Eraser-style lockset pass over
    ``self.``-attributes and mutable module globals shared across
    contexts — a shared location written with an empty or inconsistent
    guarding lockset is a finding. Reads-only sharing,
    init-before-spawn, and caller-held locks (the ``_locked`` suffix
    convention) are recognized; deliberate benign races carry
    ``# ccaudit: allow-race-lockset(reason)``.

v4 taught the analyzer the event-loop concurrency model
(``asyncflow.py`` over the same call graph — docs/analysis.md §v4),
because since ISSUE 13 the coordination substrate is an asyncio core
the thread passes could not see into:

``await-atomicity``
    An ``await`` in an ``async def`` is a visible interleaving point:
    read-check-write of a ``self.``-attribute or module global spanning
    an await without a common *asyncio* lock (caller-held ⋂-fixpoint
    included) fires; ``allow-await-atomicity(reason)`` documents a
    single-loop invariant.
``lock-across-await``
    A *threading* lock held at an await parks the entire loop.
``loop-affinity`` / ``loop-self-deadlock``
    Loop-owned state (attrs of the async-core classes written in
    coroutines, or holding asyncio queues/futures/tasks) touched from
    sync land — a sync method not provably loop-confined via the call
    graph, or an attribute chain through a typed reference anywhere in
    the tree — fires ``loop-affinity``; ``bridge.call``/``gather`` or a
    bridge future's ``.result()`` from INSIDE a coroutine is
    ``loop-self-deadlock`` at error severity.
``orphan-task`` / ``async-exception``
    Dropped ``create_task``/``ensure_future`` handles and discarded
    coroutine calls fire; in the async core, an ``except`` that exits a
    request path without settling/propagating pending entries (the
    gather-settles-everything contract, docs/io.md) is flagged via a
    settle-sink summary over the call graph.

v5 taught the analyzer the JAX dispatch model (``jitflow.py`` over the
same call graph and caller-held ⋂-fixpoint — docs/analysis.md §v5),
ahead of the multi-host planner refactor (ROADMAP item 1) that
multiplies the dispatch surface:

``retrace-hazard``
    Shape/static arguments of jitted callables and jit factories are
    classified on a CONST ⊑ BUCKETED ⊑ DYNAMIC provenance lattice;
    anything not derived from the sanctioned bucket ladder
    (``bucket_nodes``/``bucket_pools``, a snapshot's ``.bucket``)
    at a geometry/static position is a silent multi-second recompile
    in the tick path. ``allow-retrace(reason)`` suppresses.
``host-sync-in-hot-path``
    Implicit device→host transfers (``float()``/``int()``/``bool()``/
    ``np.asarray``/``.item()``/iteration on jit outputs) and
    ``.block_until_ready()`` reachable from reconcile/scan call paths
    stall the controller thread; ``jax.device_get`` is the sanctioned
    explicit transfer. bench/scripts/simlab exempt;
    ``allow-host-sync(reason)`` suppresses.
``unserialized-dispatch``
    Every dispatch of a ``shard_map``-wrapped collective program must
    hold ``_DISPATCH_LOCK`` (plan.py:746 — PR 7's rendezvous stalls),
    lexically or via the caller-held ⋂-fixpoint. Error severity.
``donation-violation``
    An argument at a ``donate_argnums`` position read after the
    donating call sees freed device memory (statement-order).
``tracer-leak``
    Writes to ``self.``/module globals inside traced bodies run once
    per (re)trace, not per call; ``if``/``while`` on a traced
    parameter is a trace-time TypeError. Static/keyword-only config
    parameters and ``is None`` defaulting are exempt.

v6 taught the analyzer overload discipline (``resourceflow.py`` over
the same parse + call graph — docs/analysis.md §v6), the down-payment
on ROADMAP item 3: a saturated control plane must degrade deliberately,
and these five families make the disciplines un-regressable:

``unbounded-queue``
    Queue/asyncio.Queue family constructors without a positive
    ``maxsize``, ``queue.SimpleQueue`` anywhere, and cross-context
    deques (``self.``/module/class stores) without ``maxlen``. The aio
    writer backlog was the seeded true positive — now bounded behind
    ``TPU_CC_KUBE_QUEUE`` with ``tpu_cc_kube_queue_rejected_total``
    accounting. Error severity; ``allow-unbounded-queue(reason)``.
``missing-deadline``
    A BOUNDED/UNBOUNDED timeout lattice over the reconcile/scan/flip
    closure (widened with the k8s I/O core): ``.result()``,
    ``concurrent.futures.wait``, subprocess, requests, ``select`` and
    awaited stream/semaphore/queue suspensions must carry a deadline on
    every caller path — ``wait_for`` wrapping, deadline-clamp
    arithmetic, and timeout-forwarding parameters resolved through a
    caller-path ⋂-fixpoint all count.
``retry-discipline``
    A retry loop around an I/O sink must show all three legs — an
    attempt/deadline cap, backoff growth, jitter — lexically or via the
    called helper's call-graph closure; the two-attempt replay shape is
    exempt.
``resource-leak``
    Acquire/release path check over sockets, files, executors,
    tempfiles, subprocesses: close under ``try/finally`` or a context
    manager on all exception paths, or a visible ownership transfer;
    ``self.``-attribute acquisitions need a close site somewhere in the
    module.
``stop-aware-wait``
    Blocking waits on controller threads must ride the ``_stop``-Event
    convention (SIGTERM must never hang a flip): ``time.sleep``,
    stopless no-timeout ``.wait()``/queue ``.get()``, and timed waits
    in loops that never consult the stop signal all fire — error
    severity when the wait sits in a loop.

Findings are gated against ``analysis/baseline.json`` so CI fails only on
*new* findings; stale baseline entries (the code they suppressed moved or
was fixed) also fail, so the baseline can only burn down.

Run it: ``python -m tpu_cc_manager_torch.analysis`` (wired into ``make lint``);
``--sarif PATH`` writes a SARIF 2.1.0 log CI uploads for inline PR
annotations; ``--files a.py b.py`` is the changed-files mode
(``make lint-fast``): the analysis stays whole-program but the report
is restricted to the named files, and manifests are skipped.
"""

from tpu_cc_manager_torch.analysis.core import (  # noqa: F401
    Finding,
    analyze_paths,
    analyze_source,
    repo_root,
)
from tpu_cc_manager_torch.analysis.baseline import (  # noqa: F401
    BASELINE_PATH,
    diff_against_baseline,
    load_baseline,
    write_baseline,
)

RULES = (
    "raw-acquire",
    "lock-order",
    "blocking-under-lock",
    "label-literal",
    "swallow",
    "metric-name",
    # v2 — the flow-sensitive protocol families
    "protocol-literal",
    "unvalidated-mode",
    "mode-exhaustive",
    "protocol-liveness",
    "manifest-drift",
    # v3 — the whole-program concurrency pass
    "race-lockset",
    # v4 — the async-aware families (asyncflow.py)
    "await-atomicity",
    "lock-across-await",
    "loop-affinity",
    "loop-self-deadlock",
    "orphan-task",
    "async-exception",
    # v5 — the JAX-dispatch families (jitflow.py)
    "retrace-hazard",
    "host-sync-in-hot-path",
    "unserialized-dispatch",
    "donation-violation",
    "tracer-leak",
    # v6 — the resource & overload-discipline families (resourceflow.py)
    "unbounded-queue",
    "missing-deadline",
    "retry-discipline",
    "resource-leak",
    "stop-aware-wait",
)
