"""Dep-free sampling profiler — the autopsy's "where was the time
actually going" sensor (ISSUE 15).

The flight recorder says what the process *did*; the trace spans say
how long each phase *took*; neither says what the interpreter was
*executing* while a flip sat at 4x its baseline. This module does: a
wall-clock sampler over ``sys._current_frames()`` that aggregates
per-thread stacks into folded form (``phase;outer;...;leaf count`` —
the flamegraph input format), with each sample keyed to the trace span
active on the sampled thread at sample time
(:func:`trace.span_on_thread`), so a profile of a slow flip reads
"reset: 94 samples in FakeChip.reset / jaxdev teardown" instead of an
anonymous stack soup.

Design constraints (all load-bearing):

- **dep-free**: stdlib only — the sampler must exist in the agent
  container as-is;
- **bounded**: at most ``max_stacks`` distinct aggregated stacks and
  ``max_depth`` frames each (innermost retained when truncating);
  overflow is counted, never grown into;
- **armable on demand** (:meth:`arm`/:meth:`disarm`, or
  ``TPU_CC_PROFILER=1`` at agent startup) and **auto-armed by the
  watchdog** (:meth:`capture` — a synchronous burst on the watchdog's
  own thread while the anomaly is still on the stack);
- **cheap when disarmed**: zero threads, zero samples, zero cost. The
  armed overhead is gated by the ``profiler_overhead_pct`` bench axis
  (ceiling 5%).

Folded output embeds in flight-recorder dumps
(``FlightRecorder(profiler=...)``) and in watchdog incident packets.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpu_cc_manager_torch import trace

log = logging.getLogger("tpu-cc-manager.profiler")


def _env_hz() -> float:
    """``TPU_CC_PROFILER_HZ`` override; unset/unparseable/<=0 falls
    back to the default rate."""
    try:
        hz = float(os.environ.get("TPU_CC_PROFILER_HZ", "") or 0)
    except ValueError:
        return 0.0
    return hz if hz > 0 else 0.0


class SamplingProfiler:
    """Bounded wall-clock stack sampler for one process."""

    #: default sampling rate — coarse enough that the armed flip loop
    #: stays inside the 5% bench ceiling on a 2-core sandbox, fine
    #: enough that a 0.25 s watchdog capture lands ~6 ticks
    DEFAULT_HZ = 25.0
    #: innermost frames retained per stack (the leaf is what names the
    #: hot code; a deeper prefix is context, not signal)
    MAX_DEPTH = 24
    #: distinct aggregated stacks retained; beyond this, new stacks are
    #: counted as overflow instead of growing the table
    MAX_STACKS = 512

    def __init__(
        self,
        hz: Optional[float] = None,
        *,
        name: str = "",
        max_depth: int = MAX_DEPTH,
        max_stacks: int = MAX_STACKS,
    ):
        self.name = name
        self.hz = hz or _env_hz() or self.DEFAULT_HZ
        self.max_depth = max_depth
        self.max_stacks = max_stacks
        #: (phase, folded-stack tuple) -> sample count
        self._counts: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._lock = threading.Lock()
        self.samples_total = 0
        self.ticks_total = 0
        self.overflow_dropped = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._deadline: Optional[float] = None

    # ------------------------------------------------------------ sampling
    def sample_once(self) -> int:
        """One sampling tick: snapshot every OTHER thread's stack and
        fold it under the span active on that thread. Returns the
        number of threads sampled. Never raises — a torn frame walk
        costs one sample."""
        try:
            frames = sys._current_frames()
        except Exception:  # ccaudit: allow-swallow(observability sampler: an interpreter that cannot enumerate frames costs one tick, never the process)
            return 0
        me = threading.get_ident()
        sampled = 0
        entries: List[Tuple[str, Tuple[str, ...]]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # the sampler's own stack is noise
            try:
                stack: List[str] = []
                f = frame
                depth = 0
                while f is not None and depth < self.max_depth:
                    code = f.f_code
                    mod = os.path.splitext(
                        os.path.basename(code.co_filename))[0]
                    stack.append(f"{mod}:{code.co_name}")
                    f = f.f_back
                    depth += 1
                stack.reverse()  # folded convention: root;...;leaf
                span = trace.span_on_thread(ident)
                phase = span.name if span is not None else "-"
            except Exception:  # ccaudit: allow-swallow(sampler contract: one thread's torn frame walk costs that thread's sample this tick — an escaped exception would kill the armed sampler thread permanently)
                continue
            entries.append((phase, tuple(stack)))
            sampled += 1
        with self._lock:
            for key in entries:
                if (key not in self._counts
                        and len(self._counts) >= self.max_stacks):
                    self.overflow_dropped += 1
                    continue
                self._counts[key] = self._counts.get(key, 0) + 1
            self.samples_total += sampled
            self.ticks_total += 1
        return sampled

    def capture(self, duration_s: float,
                hz: Optional[float] = None) -> Dict[str, object]:
        """Synchronous burst: sample on the CALLING thread for
        ``duration_s`` at ``hz``, then return :meth:`summary`. This is
        the watchdog's auto-arm — the profile is taken while the
        anomalous work is still on some thread's stack, with no
        sampler-thread handoff to miss it."""
        period = 1.0 / (hz or self.hz)
        end = time.monotonic() + max(duration_s, 0.0)
        while True:
            t0 = time.monotonic()
            if t0 >= end:
                break
            self.sample_once()
            rest = period - (time.monotonic() - t0)
            if rest > 0:
                # ccaudit: allow-stop-aware-wait(synchronous burst on the CALLER's thread, clamped to the session deadline `end` — at most one sample period outlives a shutdown; the background sampler path rides _stop.wait already)
                time.sleep(min(rest, max(end - time.monotonic(), 0.0)))
        return self.summary()

    # ------------------------------------------------------------- arming
    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def arm(self, duration_s: Optional[float] = None) -> "SamplingProfiler":
        """Start the background sampling thread (daemon; idempotent).
        ``duration_s`` bounds the session — the thread disarms itself
        at the deadline, so an operator's one-shot arm can't be left
        running forever."""
        if self.armed:
            return self
        self._stop.clear()
        self._deadline = (
            time.monotonic() + duration_s if duration_s else None
        )
        self._thread = threading.Thread(
            target=self._loop, name=f"profiler-{self.name or 'proc'}",
            daemon=True,
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            if (self._deadline is not None
                    and time.monotonic() >= self._deadline):
                return
            self.sample_once()

    def disarm(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    # ------------------------------------------------------------- reading
    def reset(self) -> None:
        """Drop the aggregate (a fresh capture window)."""
        with self._lock:
            self._counts.clear()
            self.samples_total = 0
            self.ticks_total = 0
            self.overflow_dropped = 0

    def folded(self, limit: Optional[int] = None) -> List[str]:
        """Aggregated stacks in folded-flamegraph form, hottest first:
        ``phase;root;...;leaf count``."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: -kv[1]
            )
        if limit is not None:
            items = items[:limit]
        return [
            ";".join((phase,) + stack) + f" {count}"
            for (phase, stack), count in items
        ]

    def phase_totals(self) -> List[Tuple[str, int]]:
        """Sample counts aggregated per trace phase, hottest first —
        idle untraced threads (phase ``-``: the HTTP server's accept
        pool, event loops parked in select) excluded. THIS is what
        names the guilty phase in an incident packet: the hottest
        span-tagged phase at sample time."""
        with self._lock:
            items = list(self._counts.items())
        totals: Dict[str, int] = {}
        for (phase, _stack), count in items:
            if phase == "-":
                continue
            totals[phase] = totals.get(phase, 0) + count
        return sorted(totals.items(), key=lambda kv: -kv[1])

    def summary(self, limit: int = 20) -> Dict[str, object]:
        """The embed shape (flight-recorder dumps, incident packets):
        accounting, the per-phase totals, and the hottest ``limit``
        folded stacks."""
        with self._lock:
            samples = self.samples_total
            ticks = self.ticks_total
            distinct = len(self._counts)
            overflow = self.overflow_dropped
        return {
            "hz": self.hz,
            "ticks": ticks,
            "samples": samples,
            "distinct_stacks": distinct,
            "overflow_dropped": overflow,
            "phase_totals": [
                list(kv) for kv in self.phase_totals()
            ],
            "folded": self.folded(limit),
        }
