"""The open-loop writer: one thread that sends each scheduled write to the
stand-in when it falls due, whatever the system under test is doing, and
logs when it was due, when the call began and returned, and the
resourceVersion the stand-in gave it."""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

from portbench.traffic import Schedule, patch_for


class Write(NamedTuple):
    seq: int          # index into the schedule
    node: int
    kind: int
    due: float        # monotonic
    begin: float      # monotonic, call made
    end: float        # monotonic, call returned
    rv: int
    patch: dict


class Writer(threading.Thread):
    """Runs ``schedule`` from ``t0`` (monotonic; ``wall0`` the wall clock
    at the same instant) until it is done or :meth:`stop` is called."""

    def __init__(self, standin, schedule: Schedule, fleet: List[dict],
                 cfg: dict, key: bytes, t0: float, wall0: float) -> None:
        super().__init__(name="portbench-writer", daemon=True)
        self.standin = standin
        self.schedule = schedule
        self.names = [n["metadata"]["name"] for n in fleet]
        self.cfg = cfg
        self.key = key
        self.t0 = t0
        self.wall0 = wall0
        self.log: List[Write] = []
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()

    def stop(self) -> None:
        self._stop_event.set()

    def run(self) -> None:
        s = self.schedule
        try:
            for seq in range(len(s.t)):
                due = self.t0 + float(s.t[seq])
                wait = due - time.monotonic()
                if wait > 0 and self._stop_event.wait(wait):
                    return
                if self._stop_event.is_set():
                    return
                node = int(s.node[seq])
                kind = int(s.kind[seq])
                name = self.names[node]
                patch = patch_for(kind, name, bool(s.failing[seq]), s.target,
                                  self.wall0 + float(s.t[seq]), self.cfg,
                                  self.key)
                begin = time.monotonic()
                out = self.standin.patch_node(name, patch)
                end = time.monotonic()
                self.log.append(Write(seq, node, kind, due, begin, end,
                                      int(out["metadata"]["resourceVersion"]),
                                      patch))
        except BaseException as e:  # reported by the driver, never lost
            self.error = e


def lateness_s(log: List[Write], lo: float, hi: float) -> List[float]:
    """How late each write due in ``[lo, hi)`` was sent."""
    return [w.begin - w.due for w in log if lo <= w.due < hi]

