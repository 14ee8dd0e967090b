"""Bounded-concurrency flip executor — overlap the per-device stalls.

The reference flips devices one at a time (reference main.py:258-311)
and the engine inherited that shape, so a multi-chip host paid
N × (stage + reset + wait_ready + verify) even though the dominant cost
— the post-reset boot wait (real_chip_flip_s decomposition, BENCH_NOTES
r05) — is pure waiting that overlaps perfectly across devices. This
module is the overlap: each plan item's full per-device sequence runs on
a worker thread, with a bounded pool so a 256-chip host doesn't spawn
256 resets at once.

Contract (docs/engine.md states it for the whole engine):

- ``concurrency <= 1`` (or a single item) runs the items serially in the
  CALLING thread — the historical loop, byte-identical in trace-span
  order, with its fail-stop semantics: the first failure leaves every
  later item untouched ("skipped").
- ``concurrency > 1`` runs up to that many items at once. The first
  failure sets an abort flag: **in-flight items run to completion of
  their own sequence** (a device is never abandoned mid-reset —
  half-applied hardware state is worse than a slow failure), while
  **not-yet-started items observe the flag and are skipped untouched**.
- :class:`~tpu_cc_manager.device.base.DeviceError` from an item is a
  *failure outcome* (the engine logs it and fails the flip); any other
  exception is re-raised — first in item order, but only **after** every
  in-flight sibling completed — preserving the serial path's
  unexpected-failure surface (engine._drain_wrapped catches it and
  publishes ``cc.mode.state=failed``).
- Span parenting survives the thread hop: the submitting thread's
  current span is adopted by every worker (trace.Tracer.adopt), so
  per-device ``flip``/``stage``/``reset``/``wait_ready``/``verify``
  spans nest under the reconcile exactly as they did serially.

The knob: ``TPU_CC_FLIP_CONCURRENCY`` (or the engine's constructor
override). Unset → ``min(4, plan size)``; ``1`` → the serial loop.

Lock discipline note (ccaudit blocking-under-lock): ``Future.result()``
and the executor shutdown are blocking waits on OTHER threads — this
module deliberately holds no lock across them, and the analyzer's
executor rule (docs/analysis.md) keeps it that way everywhere else too.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, TypeVar

from tpu_cc_manager_torch.device.base import DeviceError
from tpu_cc_manager_torch.trace import Tracer

log = logging.getLogger("tpu-cc-manager.flipexec")

T = TypeVar("T")
S = TypeVar("S")

#: Environment knob; ``1`` restores the serial per-device loop exactly.
ENV_KNOB = "TPU_CC_FLIP_CONCURRENCY"

#: Default ceiling when the knob is unset: enough to overlap the boot
#: waits of a typical 4-chip host without turning an 8-chip reset into
#: a host-wide power/thermal event.
DEFAULT_CAP = 4

#: FlipOutcome.status values.
OK = "ok"
FAILED = "failed"
SKIPPED = "skipped"


def flip_concurrency_knob(override: Optional[int] = None) -> int:
    """Resolve the UNCLAMPED flip-concurrency knob (the worker-pool
    ceiling a persistent executor should be sized to): ``override``
    (the engine's constructor knob) wins over the
    ``TPU_CC_FLIP_CONCURRENCY`` environment knob; unset/empty means
    ``DEFAULT_CAP``. Invalid values raise DeviceError so a typo'd
    DaemonSet env fails the flip loudly (state label ``failed``)
    instead of silently picking some cap."""
    cap = override
    if cap is None:
        raw = os.environ.get(ENV_KNOB, "").strip()
        if raw:
            try:
                cap = int(raw)
            except ValueError:
                raise DeviceError(
                    f"invalid {ENV_KNOB} {raw!r}: expected a positive integer"
                ) from None
    if cap is None:
        cap = DEFAULT_CAP
    if cap < 1:
        # name the knob the bad value actually came from
        source = "flip_concurrency override" if override is not None else ENV_KNOB
        raise DeviceError(
            f"invalid {source}={cap}: expected a positive integer"
        )
    return cap


def flip_concurrency(n_items: int, override: Optional[int] = None) -> int:
    """Effective flip concurrency for a plan of ``n_items``: the knob
    (see :func:`flip_concurrency_knob`) clamped to the plan size."""
    return max(1, min(flip_concurrency_knob(override), n_items))


@dataclass
class FlipOutcome:
    """Terminal state of one plan item after the executor ran it."""

    label: str  #: device path (display / logging key)
    status: str  #: OK | FAILED | SKIPPED
    #: engine-facing failure text; None for verify mismatches, which the
    #: flip sequence already logged (and marked on the span) in detail
    error: Optional[str] = None
    #: the exception that failed the item, when one was raised
    exception: Optional[BaseException] = None


def _note_failures(outcomes: Sequence[FlipOutcome],
                   recorder: Optional[Any]) -> None:
    """Record every non-OK item disposition in the flight recorder
    (flightrec.py, ISSUE 8): after a multi-chip failure the black box
    answers "which device failed, and which siblings were skipped vs
    ran to completion" without correlating log lines. OK items stay
    out of the ring — failures are the signal."""
    if recorder is None:
        return
    for o in outcomes:
        if o.status != OK:
            recorder.note(
                "flip_item", device=o.label, status=o.status,
                error=o.error,
            )


def _reraise_unexpected(outcomes: Sequence[FlipOutcome]) -> None:
    """Re-raise the first (in item order) non-DeviceError exception.

    DeviceError is the expected failure currency — the engine logs it
    and fails the flip. Anything else is a bug surface and must keep
    propagating to _drain_wrapped's unexpected-failure handler, exactly
    as it did when the loop was serial.
    """
    for o in outcomes:
        if o.exception is not None and not isinstance(o.exception, DeviceError):
            raise o.exception


def submit_overlapped(side: Callable[[], S]) -> "Future[S]":
    """Start ``side`` on the shared aio-bridge executor (ISSUE 13: the
    flip path hides synchronous waits behind the same loop thread the
    async kube core runs on). The caller MUST join via
    :func:`join_overlapped` on every path — an abandoned side task
    could outlive the flip whose ordering protected it."""
    from tpu_cc_manager_torch.k8s.aio_bridge import get_bridge

    return get_bridge().submit(side)


def join_overlapped(fut: "Future[S]", *, swallow: bool = False) -> Optional[S]:
    """Join a :func:`submit_overlapped` side task. ``swallow=True`` is
    the fail-secure path: the primary phase already failed and owns
    the error surface, so the side's own failure is logged (never
    silently lost) but not raised over the primary's."""
    if not swallow:
        return fut.result()
    try:
        return fut.result()
    except Exception:
        log.warning(
            "overlapped side task failed under a primary-phase "
            "failure; primary error wins", exc_info=True,
        )
        return None


def run_flips(
    items: Sequence[T],
    flip_one: Callable[[T], bool],
    *,
    concurrency: int,
    tracer: Tracer,
    label_of: Callable[[T], str],
    executor: Optional[ThreadPoolExecutor] = None,
    recorder: Optional[Any] = None,
) -> List[FlipOutcome]:
    """Run ``flip_one`` over ``items`` with bounded concurrency.

    ``flip_one`` returns True on success, False on a (already-logged)
    verify mismatch, and raises DeviceError on device failure. See the
    module docstring for the full serial/parallel contract.

    ``executor``: an optional PERSISTENT worker pool owned by the
    caller (the long-lived agent's engine): reusing it across
    reconciles avoids paying thread spawn/teardown — and, with the
    shared HTTP connection pool, connection churn — on every flip.
    Must be sized to at least ``concurrency`` workers (the engine sizes
    it to the unclamped knob, which upper-bounds every per-plan cap);
    the caller owns its shutdown. When None, a pool is created and torn
    down per call, the historical behavior.
    """

    def run_one(item: T) -> FlipOutcome:
        name = label_of(item)
        try:
            ok = flip_one(item)
        except DeviceError as e:
            return FlipOutcome(name, FAILED, error=str(e), exception=e)
        except BaseException as e:
            return FlipOutcome(
                name, FAILED, error=f"{type(e).__name__}: {e}", exception=e
            )
        return FlipOutcome(name, OK if ok else FAILED)

    if concurrency <= 1 or len(items) <= 1:
        # serial fail-stop: the historical per-device loop, in the
        # calling thread — trace-span order is byte-identical to the
        # pre-pipeline engine, and items after a failure stay untouched
        outcomes: List[FlipOutcome] = []
        aborted = False
        for item in items:
            if aborted:
                outcomes.append(FlipOutcome(label_of(item), SKIPPED))
                continue
            out = run_one(item)
            outcomes.append(out)
            if out.status != OK:
                aborted = True
        _note_failures(outcomes, recorder)
        _reraise_unexpected(outcomes)
        return outcomes

    abort = threading.Event()
    parent = tracer.current_span()

    def worker(item: T) -> FlipOutcome:
        # the abort check is the ONLY pre-start gate: once a worker is
        # past it the item runs its whole sequence (never cancelled
        # mid-reset), and a queued item that sees the flag is skipped
        # before it touches the device (or its gate) at all
        if abort.is_set():
            return FlipOutcome(label_of(item), SKIPPED)
        with tracer.adopt(parent):
            out = run_one(item)
        if out.status == FAILED:
            abort.set()
        return out

    with ExitStack() as stack:
        pool = executor if executor is not None else stack.enter_context(
            ThreadPoolExecutor(
                max_workers=concurrency, thread_name_prefix="cc-flip"
            )
        )
        futures = [pool.submit(worker, item) for item in items]
        # .result() outside any lock by design — see the module docstring
        # ccaudit: allow-missing-deadline(a flip worker past the abort gate is mid-device-reset and must NEVER be abandoned: timing out this join would orphan a live firmware transition — the per-step device timeouts inside the worker bound it instead)
        outcomes = [f.result() for f in futures]
    _note_failures(outcomes, recorder)
    _reraise_unexpected(outcomes)
    return outcomes
