"""The rolling window: the fleet controller, fed by a shared informer over
the stand-in, scanning back to back while the open-loop writer drives a
rolling CC-mode change and the background.

Wired as ``tpu_cc_manager_torch/shard.py`` wires a shard's controller:
``FleetController(informer.client(base), informer=informer)``. Each scan
is timed by wrapping the instance's ``scan_once`` before ``run()``
starts; the reports are kept and judged after the window.

Bounds for the judgement (``portbench.reference.check``): a report's
evidence audit reads the list the scan took from the informer's cache,
which holds every write up to the informer's resourceVersion when the
scan began. Its planner lists read the feature block, into which the
controller's informer callback writes every delta as it is handed over
(list truth only reconciles it on the scans that sync), so their lower
bound is the newest resourceVersion whose callback had returned when the
scan began; the informer hands events over one at a time in commit
order. Besides, no report may show a node older than a version an
earlier report had to show. The upper bound of both is the stand-in's
when the scan returned. The staleness flag is judged at the clock of the
last scan whose session tick was full or a rebuild (the session freezes
it in between).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from portbench.common import (
    CallLog, Context, Fleet, Outcome, lateness_note, memory_peak,
)
from portbench.measure import (
    SIGNATURE, Call, in_window, mean_s, p95, plan_lags,
)
from portbench.metrics import TraceData
from portbench.reference.check import (
    Tally, check_audit, check_plan, control_report,
)

SCAN_LAYERS = ("list", "encode", "tick", "report", "audit")


def run(ctx: Context) -> Outcome:
    import numpy as np

    from tpu_cc_manager_torch import fleet as fleet_mod
    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch.fleet import FleetController
    from tpu_cc_manager_torch.watch import NodeInformer

    out = Outcome()
    mix = ctx.mix
    if ctx.cuda:
        from tpu_cc_manager_torch.kernels import _build

        _build.library()
    fl = Fleet(ctx)
    informer = NodeInformer(fl.standin, name="portbench")
    informer.prime()
    informer.start()
    client = informer.client(fl.standin)
    ctrl = FleetController(client, interval_s=mix["scan_interval_s"],
                           port=0, informer=informer)
    log = CallLog()
    scan_once = ctrl.scan_once
    session = ctrl._tick_session
    handed = [0]
    on_event = ctrl._on_informer_event

    def stamped(etype, node):
        # the newest resourceVersion whose delta the controller has been
        # handed; the informer's own rv moves before its callbacks run
        on_event(etype, node)
        rv = int((node.get("metadata") or {}).get("resourceVersion") or 0)
        if rv > handed[0]:
            handed[0] = rv

    ctrl._on_informer_event = stamped

    def timed_scan():
        lo_rv = int(informer._rv or 0)
        lo_plan = handed[0]
        b, wb = time.monotonic(), time.time()
        rep, err = None, None
        try:
            rep = scan_once()
            return rep
        except Exception as e:
            err = repr(e)
            raise
        finally:
            e_, we = time.monotonic(), time.time()
            st = session.stats
            log.add(Call(b, e_, wb, we, lo_rv, fl.standin._rv, rep, err, {
                "handed": lo_plan,
                "full": st["full_ticks"] + st["rebuilds"]}))

    ctrl.scan_once = timed_scan
    spans = None
    restore = []
    if ctx.trace:
        from portbench.trace import Spans

        spans = Spans()
        client.list_nodes = spans.wrap("list", client.list_nodes)
        ctrl._encoding.sync = spans.wrap("encode", ctrl._encoding.sync)
        session.tick = spans.wrap("tick", session.tick)
        ctrl._on_informer_event = spans.wrap_delivery(
            ctrl._on_informer_event)
        restore = [(plan, "_format_report", plan._format_report),
                   (plan, "_eval_fn", plan._eval_fn),
                   (plan, "_scatter_fn", plan._scatter_fn),
                   (fleet_mod, "audit_evidence", fleet_mod.audit_evidence)]
        plan._format_report = spans.wrap("report", plan._format_report)
        fleet_mod.audit_evidence = spans.wrap("audit",
                                              fleet_mod.audit_evidence)
        spans.wrap_planner(plan)
    if ctx.fault is not None:
        ctx.fault({"ctrl": ctrl, "plan": plan, "client": client,
                   "fleet_module": fleet_mod, "restore": restore})
    runner = threading.Thread(target=ctrl.run, name="portbench-fleet",
                              daemon=True)
    writer = None
    prof = None
    try:
        runner.start()
        if not log.wait_until(lambda c: len(c) >= 1, 600):
            raise RuntimeError("the controller's first scan never ended")
        horizon = mix["lead_s"] + ctx.seconds + mix["drain_max_s"] + 120
        writer = fl.start_writer(ctx, horizon)
        n0 = len(log.calls)
        log.wait_until(lambda c: len(c) >= n0 + mix["warm_calls"], 600)
        rest = writer.t0 + mix["lead_s"] - time.monotonic()
        if rest > 0:
            time.sleep(rest)
        if ctx.trace:
            from portbench.trace import OPEN_MARK, Profile

            prof = Profile(ctx.cuda)
            prof.start()
            t_open = prof.mark(OPEN_MARK)
        else:
            t_open = time.monotonic()
        out.e2e["setup_s"] = t_open - ctx.t_start
        t_close = t_open + ctx.seconds
        time.sleep(max(0.0, t_close - time.monotonic()))
        if prof is not None:
            from portbench.trace import CLOSE_MARK

            prof.mark(CLOSE_MARK)
        # the scan in flight at the close is one of the window's
        log.wait_until(lambda c: c[-1].end >= t_close, 900)
        timeline = None
        if prof is not None:
            timeline = prof.stop(f"{ctx.run_dir}/trace.json")
        # bounded drain: the window's writes still unshown get more scans
        drain_end = time.monotonic() + mix["drain_max_s"]
        while True:
            _, unseen = plan_lags(log.calls, writer.log, fl.names,
                                  t_open, t_close)
            if unseen == 0 or time.monotonic() >= drain_end:
                break
            k = len(log.calls)
            log.wait_until(lambda c: len(c) > k,
                           max(0.0, drain_end - time.monotonic()))
        writer.stop()
        writer.join(timeout=60)
        out.notes.append(_rows_behind(ctrl, informer, fl.standin))
    finally:
        if writer is not None:
            writer.stop()
        ctrl.stop()
        runner.join(timeout=600)
        if writer is not None:
            writer.join(timeout=60)
        informer.stop()
        for mod, attr, val in restore:
            setattr(mod, attr, val)
    if runner.is_alive() or (writer is not None and writer.is_alive()):
        raise RuntimeError("a driver thread did not stop")
    if writer.error is not None:
        raise RuntimeError(f"the writer failed: {writer.error!r}")
    out.memory_peak_bytes = memory_peak(ctx.cuda)
    calls = log.calls
    window = in_window(calls, t_open, t_close)
    scan_s = mean_s([c for c in window if c.result is not None])
    lags, unseen = plan_lags(calls, writer.log, fl.names, t_open, t_close)
    due = sum(1 for w in writer.log
              if t_open <= w.due < t_close and w.kind in SIGNATURE)
    errors = sum(1 for c in window if c.error is not None)
    out.attempted = due + len(window)
    out.failed = unseen + errors
    if scan_s is not None:
        out.e2e["scan_s"] = scan_s
    if lags:
        out.e2e["plan_lag_p95_s"] = p95(lags)
    out.notes.append(lateness_note(writer, t_open, t_close))
    out.notes.append(
        f"scans in the window {len(window)}, raised {errors}; rolling writes "
        f"due {due}, unshown {unseen}; session stats {dict(session.stats)}; "
        f"compile stats {plan.compile_stats()}")
    if spans is not None:
        _traced(out, spans, window, timeline, writer, t_open, t_close)
    # the judgement: the plain reference over every version of every node
    del ctrl, informer, client
    t_ref = time.monotonic()
    hist = fl.history(writer)
    stale_s = int(ctx.cfg["stale_after_s"])
    plan_t, audit_t, ctl_t = Tally(), Tally(), Tally()
    floor = ctl_floor = None
    clock = None
    prev_full = None
    prev_raw: Optional[set] = None
    checked = 0
    for c in calls:
        if c.result is None:
            continue
        if prev_full is None or c.extra["full"] != prev_full:
            clock = (int(c.wall_begin), int(c.wall_end))
        prev_full = c.extra["full"]
        raw = set(c.result["evidence_audit"]["label_device_mismatch"]) | set(
            c.result["evidence_audit"]["label_device_mismatch_transient"])
        if t_open <= c.begin < t_close:
            floor = check_plan(c.result, hist, c.extra["handed"], c.hi_rv,
                               clock, stale_s, plan_t, floor=floor)
            check_audit(c.result["evidence_audit"], prev_raw, hist,
                        c.lo_rv - 1, c.hi_rv, audit_t)
            if ctx.control:
                ctl_floor = check_plan(
                    control_report(hist, hist.vids_at(c.hi_rv), clock[1],
                                   stale_s, np.int16),
                    hist, c.extra["handed"], c.hi_rv, clock, stale_s, ctl_t,
                    floor=ctl_floor)
            checked += 1
        prev_raw = raw
    # a scan that raised gave no answer: the session's verify tick
    # raises when the resident block has drifted from the host's rows
    checks = {"plan_mismatch": (plan_t.count, 0),
              "audit_mismatch": (audit_t.count, 0),
              "scans_raised": (errors, 0),
              "scans_unchecked": (int(checked == 0), 0)}
    out.notes += [f"plan: {x}" for x in plan_t.notes]
    out.notes += [f"audit: {x}" for x in audit_t.notes]
    if ctx.control:
        # the control's judgement is the run's; the program's rides in
        # the notes, a sound reading of the same seed
        out.notes.append("program: " + ", ".join(
            f"{k} {v}" for k, (v, _) in checks.items()))
        checks = {"plan_mismatch": (ctl_t.count, 0),
                  "scans_unchecked": (int(checked == 0), 0)}
        out.notes += [f"control: {x}" for x in ctl_t.notes]
    out.checks = checks
    out.notes.append(f"reference: {checked} scans judged in "
                     f"{time.monotonic() - t_ref:.3f} s")
    return out


def _rows_behind(ctrl, informer, standin) -> str:
    """Once the writes have stopped and the informer has delivered them
    all: how many of the controller's feature-block rows still differ
    from the informer's copy of their node. A diagnostic of the program's
    state, read after the window; the judgement never reads it."""
    deadline = time.monotonic() + 20
    while (int(informer._rv or 0) < standin._rv
           and time.monotonic() < deadline):
        time.sleep(0.05)
    time.sleep(0.5)
    enc = ctrl._encoding
    with informer._lock:
        nodes = list(informer._nodes.values())
    with enc._lock:
        fps = dict(enc._fp)
    behind = sum(1 for n in nodes
                 if fps.get(n["metadata"]["name"]) != enc._fingerprint(n))
    return (f"after the drain: {behind} of {len(nodes)} feature-block rows "
            "differ from the informer's copy of their node")


def _traced(out: Outcome, spans, window: List[Call], timeline, writer,
            t_open: float, t_close: float) -> None:
    from portbench import trace as T

    calls = []
    for c in window:
        ms = {}
        for name, a, b in spans.rec:
            if c.begin <= a < c.end:
                ms[name] = ms.get(name, 0.0) + 1e3 * (b - a)
        calls.append(ms)
    done = {(writer.names[w.node], w.rv): w.end for w in writer.log
            if t_open <= w.due < t_close}
    delivery = [1e3 * (t - done[(name, rv)])
                for t, name, rv in spans.deliveries if (name, rv) in done]
    roof = {"k1": None, "k2": None}
    busy = window_s = None
    if timeline is not None and timeline.aligned and timeline.device:
        roof = T.rooflines(timeline, spans.launches, t_open, t_close)
        busy, _ = timeline.busy(t_open, t_close)
        window_s = t_close - t_open
        out.breakdown = T.breakdown(
            timeline, [s for s in spans.rec if s[0] in SCAN_LAYERS],
            [(c.begin, c.end) for c in window], t_open, t_close)
    out.busy_s, out.window_s = busy, window_s
    out.trace = TraceData("scan", calls, roof, busy, window_s, delivery)
