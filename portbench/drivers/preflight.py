"""The preflight window: one operator running ``rollout --dry-run`` back to
back (a closed loop) against the stand-in while the open-loop writer
sends the background writes.

Each call builds ``Rollout(kube, mode, dry_run=True)`` and runs it, as the
``rollout --dry-run`` subcommand does: an API list, the planner's legacy
tick over a fresh feature block (upload, one K1, fetch), the report, and
the group plan with its evidence check. The list is taken under the
stand-in's lock, so a call's report and plan read the fleet at one
resourceVersion between the stand-in's before and after the call; the
staleness flag at the wall clock between them.
"""

from __future__ import annotations

import time

from portbench.common import (
    CallLog, Context, Fleet, Outcome, lateness_note, memory_peak,
)
from portbench.measure import Call, in_window, mean_s
from portbench.metrics import TraceData
from portbench.reference.check import (
    Tally, check_groups, check_plan, control_report,
)


def run(ctx: Context) -> Outcome:
    import numpy as np

    from tpu_cc_manager_torch import plan
    from tpu_cc_manager_torch import rollout as rollout_mod
    from tpu_cc_manager_torch.rollout import Rollout

    out = Outcome()
    mix = ctx.mix
    mode = mix["mode"]
    if ctx.cuda:
        from tpu_cc_manager_torch.kernels import _build

        _build.library()
    fl = Fleet(ctx)
    log = CallLog()
    spans = None
    restore = []
    if ctx.trace:
        from portbench.trace import Spans

        spans = Spans()
        restore = [(rollout_mod, "analyze_fleet", rollout_mod.analyze_fleet),
                   (plan, "analyze_encoding", plan.analyze_encoding),
                   (plan, "_tick_fn", plan._tick_fn),
                   (plan, "_format_report", plan._format_report),
                   (plan, "_eval_fn", plan._eval_fn),
                   (plan, "_scatter_fn", plan._scatter_fn),
                   (Rollout, "discover", Rollout.discover)]
        rollout_mod.analyze_fleet = spans.wrap("analyze_fleet",
                                               rollout_mod.analyze_fleet)
        plan.analyze_encoding = spans.wrap("analyze_encoding",
                                           plan.analyze_encoding)
        tick_fn = plan._tick_fn

        def traced_tick_fn(nb, pb, mesh):
            return spans.wrap("tick", tick_fn(nb, pb, mesh))

        plan._tick_fn = traced_tick_fn
        plan._format_report = spans.wrap("report", plan._format_report)
        Rollout.discover = spans.wrap("list", Rollout.discover)
        spans.wrap_planner(plan)
    if ctx.fault is not None:
        ctx.fault({"plan": plan, "rollout_module": rollout_mod,
                   "Rollout": Rollout, "restore": restore})

    def call() -> None:
        lo_rv = fl.standin._rv
        b, wb = time.monotonic(), time.time()
        rep, err = None, None
        try:
            rep = Rollout(fl.standin, mode, dry_run=True).run().to_dict()
        except Exception as e:
            err = repr(e)
        log.add(Call(b, time.monotonic(), wb, time.time(), lo_rv,
                     fl.standin._rv, rep, err, {}))

    writer = None
    prof = None
    try:
        call()
        horizon = mix["lead_s"] + ctx.seconds + 600
        writer = fl.start_writer(ctx, horizon)
        for _ in range(mix["warm_calls"]):
            call()
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
        while time.monotonic() < t_close:
            call()
        timeline = None
        if prof is not None:
            from portbench.trace import CLOSE_MARK

            prof.mark(CLOSE_MARK)
            timeline = prof.stop(f"{ctx.run_dir}/trace.json")
    finally:
        if writer is not None:
            writer.stop()
            writer.join(timeout=60)
        for mod, attr, val in restore:
            setattr(mod, attr, val)
    if writer.is_alive():
        raise RuntimeError("the writer did not stop")
    if writer.error is not None:
        raise RuntimeError(f"the writer failed: {writer.error!r}")
    out.memory_peak_bytes = memory_peak(ctx.cuda)
    window = in_window(log.calls, t_open, t_close)
    ok_calls = [c for c in window if c.result is not None]
    errors = len(window) - len(ok_calls)
    out.attempted = len(window)
    out.failed = errors
    if ok_calls:
        out.e2e["preflight_s"] = mean_s(ok_calls)
    out.notes.append(lateness_note(writer, t_open, t_close))
    out.notes.append(f"preflights in the window {len(window)}, raised "
                     f"{errors}: {[c.error for c in window if c.error][:2]}")
    if spans is not None:
        _traced(out, spans, window, timeline, t_open, t_close)
    t_ref = time.monotonic()
    hist = fl.history(writer)
    stale_s = int(ctx.cfg["stale_after_s"])
    plan_t, group_t, ctl_t = Tally(), Tally(), Tally()
    for c in ok_calls:
        clock = (int(c.wall_begin), int(c.wall_end))
        check_plan(c.result["preflight"], hist, c.lo_rv, c.hi_rv, clock,
                   stale_s, plan_t)
        check_groups(c.result["groups"], hist, c.lo_rv, c.hi_rv, mode,
                     group_t)
        if ctx.control:
            check_plan(control_report(hist, hist.vids_at(c.hi_rv), clock[1],
                                      stale_s, np.int16),
                       hist, c.lo_rv, c.hi_rv, clock, stale_s, ctl_t)
    checks = {"plan_mismatch": (plan_t.count, 0),
              "group_mismatch": (group_t.count, 0),
              "calls_unchecked": (int(not ok_calls), 0)}
    out.notes += [f"plan: {x}" for x in plan_t.notes]
    out.notes += [f"groups: {x}" for x in group_t.notes]
    if ctx.control:
        out.notes.append("program: " + ", ".join(
            f"{k} {v}" for k, (v, _) in checks.items()))
        checks = {"plan_mismatch": (ctl_t.count, 0),
                  "calls_unchecked": (int(not ok_calls), 0)}
        out.notes += [f"control: {x}" for x in ctl_t.notes]
    out.checks = checks
    out.notes.append(f"reference: {len(ok_calls)} preflights judged in "
                     f"{time.monotonic() - t_ref:.3f} s")
    return out


def _traced(out: Outcome, spans, window, timeline, t_open: float,
            t_close: float) -> None:
    from portbench import trace as T

    calls, gap_spans = [], []
    fleet_spans = [s for s in spans.rec if s[0] == "analyze_fleet"]
    enc_spans = [s for s in spans.rec if s[0] == "analyze_encoding"]
    for c in window:
        ms = {}
        for name, a, b in spans.rec:
            if c.begin <= a < c.end and name in ("list", "tick", "report"):
                ms[name] = ms.get(name, 0.0) + 1e3 * (b - a)
                gap_spans.append((name, a, b))
        for _, a, b in fleet_spans:
            if c.begin <= a < c.end:
                inner = [s for s in enc_spans if a <= s[1] < b]
                split = inner[0][1] if inner else b
                ms["encode"] = ms.get("encode", 0.0) + 1e3 * (split - a)
                gap_spans.append(("encode", a, split))
                if inner:
                    gap_spans.append(("plan (other)", inner[0][1],
                                      inner[0][2]))
                gap_spans.append(("groups", b, c.end))
        calls.append(ms)
    roof = {"k1": None, "k2": None}
    busy = window_s = None
    if timeline is not None and timeline.aligned and timeline.device:
        roof = T.rooflines(timeline, spans.launches, t_open, t_close)
        busy, _ = timeline.busy(t_open, t_close)
        window_s = t_close - t_open
        out.breakdown = T.breakdown(
            timeline, gap_spans, [(c.begin, c.end) for c in window],
            t_open, t_close)
    out.busy_s, out.window_s = busy, window_s
    out.trace = TraceData("preflight", calls, roof, busy, window_s)
