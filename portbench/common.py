"""What every driver shares: the run's context, the fleet in the stand-in,
the background writer, and the result a driver hands back."""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from portbench import fleetgen as G
from portbench.measure import Call
from portbench.reference.history import History
from portbench.traffic import make_schedule
from portbench.writer import Writer, lateness_s


class Context:
    """One run of one cell."""

    def __init__(self, *, cfg: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, control: bool, cuda: bool, t_start: float,
                 run_dir: str,
                 fault: Optional[Callable[[dict], None]] = None) -> None:
        self.cfg = cfg
        self.mix = mix
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.control = control
        self.cuda = cuda
        self.t_start = t_start
        self.run_dir = run_dir
        #: tests only: breaks the timed path (given the driver's objects)
        #: to show that ``correct`` then comes out false
        self.fault = fault


class Outcome:
    """What a driver hands back to the harness."""

    def __init__(self) -> None:
        self.e2e: Dict[str, float] = {}
        self.trace = None
        self.breakdown: Optional[dict] = None
        self.attempted = 0
        self.failed = 0
        #: name -> (number compared, its limit); correct needs each <= limit
        self.checks: Dict[str, Tuple[float, float]] = {}
        self.notes: List[str] = []
        self.memory_peak_bytes = 0
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None


class Fleet:
    """The cell's fleet, made from the seed and filled into a fresh
    stand-in; ``key`` is the seed's evidence key, also set in the
    environment the program reads it from."""

    def __init__(self, ctx: Context) -> None:
        from portbench.standin import FakeKube

        self.key = G.evidence_key(ctx.seed)
        os.environ["TPU_CC_EVIDENCE_KEY"] = self.key.decode()
        self.nodes = G.make_fleet(ctx.cfg, ctx.seed, time.time())
        self.standin = FakeKube(watch_history_limit=ctx.mix["watch_history"])
        # the fleet exists before the run: stored and versioned as
        # add_node does, without an ADDED event each (the informer
        # primes by LIST, and a watch history of the whole fleet would
        # only be compacted away)
        with self.standin._lock:
            for node in self.nodes:
                self.standin._bump(node)
                self.standin._nodes[node["metadata"]["name"]] = node
        # the stand-in's store is an API server's, another process's
        # memory in a deployment: keep its objects (and those made so
        # far) out of this process's garbage collections, which the
        # program's own objects still pay
        gc.freeze()
        self.names = [n["metadata"]["name"] for n in self.nodes]

    def start_writer(self, ctx: Context, horizon_s: float) -> Writer:
        sched = make_schedule(self.nodes, ctx.cfg, ctx.mix, ctx.seed,
                              horizon_s)
        w = Writer(self.standin, sched, self.nodes, ctx.cfg, self.key,
                   time.monotonic(), time.time())
        w.start()
        return w

    def history(self, writer: Writer) -> History:
        """The plain reference's record of every node version."""
        hist = History(self.nodes, self.key)
        for w in sorted(writer.log, key=lambda w: w.rv):
            hist.add(w.rv, w.node, w.patch)
        hist.arrays()
        return hist


class CallLog:
    """Timed calls, with a condition to wait on their count."""

    def __init__(self) -> None:
        self.calls: List[Call] = []
        self.cond = threading.Condition()

    def add(self, call: Call) -> None:
        with self.cond:
            self.calls.append(call)
            self.cond.notify_all()

    def wait_until(self, pred: Callable[[List[Call]], bool],
                   timeout_s: float) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: pred(self.calls), timeout_s)


def lateness_note(writer: Writer, lo: float, hi: float) -> str:
    late = sorted(lateness_s(writer.log, lo, hi))
    if not late:
        return "writer: no writes due in the window"
    return (f"writer: {len(late)} writes due in the window, late by "
            f"median {late[len(late) // 2] * 1e3:.3f} ms, "
            f"p95 {late[int(0.95 * (len(late) - 1))] * 1e3:.3f} ms, "
            f"max {late[-1] * 1e3:.3f} ms")


def memory_peak(cuda: bool) -> int:
    if not cuda:
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(0))
