"""The traced run's instruments: spans taken by wrapping the calls into
each layer from the benchmark's side, the kernel launches the planner
asks for, and the device timeline from ``torch.profiler``.

Nothing here is installed in an untraced run. The program has no spans
of its own yet; these wrappers stand in for them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from portbench import bounds

#: device activity categories in the profiler's trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OPEN_MARK = "portbench.window.open"
CLOSE_MARK = "portbench.window.close"


class Spans:
    """Host spans, ``(name, begin, end)`` on the monotonic clock, each
    also a ``torch.profiler.record_function`` range."""

    def __init__(self) -> None:
        self.rec: List[Tuple[str, float, float]] = []
        self.launches: List[tuple] = []
        self.deliveries: List[Tuple[float, str, int]] = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        from torch.profiler import record_function

        rec = self.rec

        def wrapped(*args, **kwargs):
            t0 = time.monotonic()
            try:
                with record_function("portbench." + name):
                    return fn(*args, **kwargs)
            finally:
                rec.append((name, t0, time.monotonic()))
        return wrapped

    def wrap_planner(self, plan) -> None:
        """Log each K1 call (``plan._eval_fn``'s runner: node and pool
        buckets) and each K2 call (``plan._scatter_fn``'s runner: node
        and delta buckets, live rows)."""
        launches = self.launches
        eval_fn, scatter_fn = plan._eval_fn, plan._scatter_fn

        def logged_eval(nb, pb, mesh):
            run = eval_fn(nb, pb, mesh)

            def k1(*args, **kwargs):
                launches.append(("k1", time.monotonic(), nb, pb, nb))
                return run(*args, **kwargs)
            return k1

        def logged_scatter(nb, kb, mesh):
            run = scatter_fn(nb, kb, mesh)

            def k2(shards, idx, vals):
                live = int(((idx >= 0) & (idx < nb)).sum())
                launches.append(("k2", time.monotonic(), nb, kb, live))
                return run(shards, idx, vals)
            return k2

        plan._eval_fn = logged_eval
        plan._scatter_fn = logged_scatter

    def wrap_delivery(self, fn: Callable) -> Callable:
        """The controller's informer callback, stamped per event."""
        out = self.deliveries

        def delivered(etype, node):
            meta = node.get("metadata") or {}
            out.append((time.monotonic(), meta.get("name"),
                        int(meta.get("resourceVersion") or 0)))
            return fn(etype, node)
        return delivered


class Profile:
    """``torch.profiler`` over the window, with two marks in the main
    thread that tie its clock to the monotonic one."""

    def __init__(self, cuda: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.marks: Dict[str, float] = {}

    def start(self) -> None:
        self.prof.start()

    def mark(self, name: str) -> float:
        from torch.profiler import record_function

        with record_function(name):
            t = time.monotonic()
        self.marks[name] = t
        return t

    def stop(self, path: str) -> "Timeline":
        self.prof.stop()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        return Timeline(doc.get("traceEvents") or [], self.marks)


class Timeline:
    """Device intervals from a chrome trace, on the monotonic clock."""

    def __init__(self, events: List[dict], marks: Dict[str, float]) -> None:
        ts = {}
        dev: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            if e.get("name") in (OPEN_MARK, CLOSE_MARK):
                ts[e["name"]] = float(e["ts"])
            elif e.get("cat") in DEVICE_CATS:
                dev.append((str(e.get("name")), float(e["ts"]),
                            float(e.get("dur", 0.0))))
        offs = [marks[k] - ts[k] / 1e6 for k in ts if k in marks]
        self.aligned = bool(offs)
        off = sum(offs) / len(offs) if offs else 0.0
        self.device = sorted((name, t / 1e6 + off, d / 1e6)
                             for name, t, d in dev)
        self.device.sort(key=lambda x: x[1])

    def within(self, lo: float, hi: float) -> List[Tuple[str, float, float]]:
        return [x for x in self.device if lo <= x[1] < hi]

    def busy(self, lo: float, hi: float) -> Tuple[float, List[Tuple[float, float]]]:
        """Seconds some device activity ran in ``[lo, hi)``, and the
        merged busy intervals."""
        merged: List[List[float]] = []
        for _, t, d in self.within(lo, hi):
            a, b = t, min(t + d, hi)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def short(name: str) -> str:
    """A device operation's name without its signature, template
    arguments, namespaces or return type (``(anonymous
    namespace)::tick_rows(int const*, ...)`` is ``tick_rows``)."""
    name = name.replace("(anonymous namespace)::", "")
    base = name.split("(")[0].split("<")[0].split("::")[-1].strip()
    return (base.split()[-1] if base.split() else name.strip())[:80]


def kernel_time_s(tl: Timeline, lo: float, hi: float,
                  names: Tuple[str, ...]) -> Tuple[float, int]:
    """Device seconds of the kernels named, and how many launches."""
    hits = [d for n, _, d in tl.within(lo, hi) if short(n) in names]
    return sum(hits), len(hits)


def rooflines(tl: Timeline, launches: List[tuple], lo: float, hi: float
              ) -> Dict[str, Optional[float]]:
    """K1's and K2's share of their roofline over the window, in %: the
    least time the launches made in the window need, over the device
    time the profiler gave their kernels. None where the window holds
    none of a kernel's launches."""
    out: Dict[str, Optional[float]] = {"k1": None, "k2": None}
    k1 = [x for x in launches if x[0] == "k1" and lo <= x[1] < hi]
    _, k1_n = kernel_time_s(tl, lo, hi, ("tick_rows",))
    k1_all_s, _ = kernel_time_s(tl, lo, hi, bounds.K1_KERNELS)
    if k1 and k1_n and k1_all_s > 0:
        n = min(len(k1), k1_n)
        need_ms = sum(bounds.k1_bound_ms(nb, pb, slots)
                      for _, _, nb, pb, slots in k1[:n])
        out["k1"] = 100.0 * need_ms / (1e3 * k1_all_s * n / k1_n)
    k2 = [x for x in launches if x[0] == "k2" and lo <= x[1] < hi]
    k2_hits = [d for n, _, d in tl.within(lo, hi)
               if short(n) in bounds.K2_KERNELS]
    if k2 and k2_hits:
        n = min(len(k2), len(k2_hits))
        need_ms = sum(bounds.k2_bound_ms(kb, live)
                      for _, _, _, kb, live in k2[:n])
        out["k2"] = 100.0 * need_ms / (1e3 * sum(k2_hits[:n]))
    return out


def breakdown(tl: Timeline, spans: List[Tuple[str, float, float]],
              calls: List[Tuple[float, float]], lo: float, hi: float
              ) -> Dict[str, list]:
    """The ten device operations that took most time, and the ten
    longest idle gaps, each named by what covers most of it: a benchmark
    span, ``call (other)`` (inside a timed call, outside every span) or
    ``between calls``."""
    per: Dict[str, float] = {}
    for name, _, d in tl.within(lo, hi):
        per[short(name)] = per.get(short(name), 0.0) + d
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    _, busy = tl.busy(lo, hi)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for a, b in gaps[:10]:
        over: Dict[str, float] = {}
        for name, s0, s1 in spans:
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                over[name] = over.get(name, 0.0) + ov
        in_calls = sum(max(0.0, min(b, c1) - max(a, c0)) for c0, c1 in calls)
        over["call (other)"] = in_calls - sum(over.values())
        over["between calls"] = (b - a) - in_calls
        named.append([max(over, key=over.get), b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
