"""The preflight window over an attested fleet: the ``preflight`` driver's
closed loop of ``rollout --dry-run`` under the kubelet's and the
doctor's background writes, on a fleet whose every evidence document
carries an RS256 instance-identity token and an RS256 attestation token
committed to the document, verified offline against two JWKS files.

Before CUDA starts, the driver makes the seed's RSA keys, writes the two
JWKS files under the run directory and points the verifiers at them
(``TPU_CC_IDENTITY_JWKS_FILE``, ``TPU_CC_ATTESTATION_JWKS_FILE``), and
re-signs the fleet ``fleetgen.make_fleet`` made with both tokens
(:mod:`portbench.attestgen`), the attested shares planted. The loop, the
timing, the traced spans and the plan's judgement are the ``preflight``
driver's; each preflight's group plan is judged by
:mod:`portbench.reference.attested`, which checks the tokens itself at
the call's wall clock. In a traced run each preflight's token verdict
counts, from the program's ``groups`` span, are held to the
reference's in a note.
"""

from __future__ import annotations

import gc
import json
import os
import time

from portbench import attestgen as A
from portbench import fleetgen as G
from portbench.common import (
    CallLog, Context, Fleet, Outcome, lateness_note, memory_peak,
)
from portbench.measure import Call, in_window, mean_s
from portbench.reference.attested import Tokens, check_groups
from portbench.reference.check import Tally, check_plan, control_report


class AttestedFleet(Fleet):
    """:class:`portbench.common.Fleet` over nodes already made."""

    def __init__(self, ctx: Context, nodes, key: bytes) -> None:
        from portbench.standin import FakeKube

        self.key = key
        os.environ["TPU_CC_EVIDENCE_KEY"] = key.decode()
        self.nodes = nodes
        self.standin = FakeKube(watch_history_limit=ctx.mix["watch_history"])
        with self.standin._lock:
            for node in self.nodes:
                self.standin._bump(node)
                self.standin._nodes[node["metadata"]["name"]] = node
        gc.freeze()
        self.names = [n["metadata"]["name"] for n in self.nodes]


def mint(ctx: Context):
    """The seed's fleet with both tokens in every document, its evidence
    key, what was planted, and the JWKS files' environment (set here)."""
    key = G.evidence_key(ctx.seed)
    now = time.time()
    nodes = G.make_fleet(ctx.cfg, ctx.seed, now)
    keys = A.make_keys(ctx.seed, ctx.cfg)
    planted = A.attest_fleet(nodes, ctx.cfg, ctx.seed, key, now, keys)
    env = A.write_jwks(ctx.run_dir, keys)
    os.environ.update(env)
    return nodes, key, planted, env


def run(ctx: Context) -> Outcome:
    import numpy as np

    nodes, key, planted, env = mint(ctx)
    t_minted = time.time()

    from tpu_cc_manager_torch import attest, identity, plan
    from tpu_cc_manager_torch import rollout as rollout_mod
    from tpu_cc_manager_torch.rollout import Rollout

    out = Outcome()
    mix = ctx.mix
    mode = mix["mode"]
    require = tuple(ctx.cfg["env"].get(v, "").lower() in ("1", "true", "yes")
                    for v in ("TPU_CC_REQUIRE_IDENTITY",
                              "TPU_CC_REQUIRE_ATTESTATION"))
    if ctx.cuda:
        from tpu_cc_manager_torch.kernels import _build

        _build.library()
    fl = AttestedFleet(ctx, nodes, key)
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
                   "Rollout": Rollout, "identity": identity,
                   "attest": attest, "restore": restore})

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
        wall_close = time.time()
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
    out.notes.append(
        "tokens: " + ", ".join(f"{k} {len(v)}" for k, v in
                               planted.kinds.items())
        + "; the first valid one expires "
        f"{planted.valid_exp_min - wall_close:.0f} s after the window "
        "closed, the last expired one "
        + (f"{t_minted - planted.expired_exp_max:.0f} s before it was minted"
           if planted.expired_exp_max is not None else "none"))
    if spans is not None:
        from portbench.drivers.preflight import _traced

        _traced(out, spans, window, timeline, t_open, t_close)
    t_ref = time.monotonic()
    hist = fl.history(writer)
    with open(env["TPU_CC_IDENTITY_JWKS_FILE"]) as f:
        id_jwks = json.load(f)
    with open(env["TPU_CC_ATTESTATION_JWKS_FILE"]) as f:
        att_jwks = json.load(f)
    tokens = Tokens(fl.nodes, sorted((w.rv, w.node, w.patch)
                                     for w in writer.log),
                    id_jwks, att_jwks, ctx.cfg["tokens"]["audience"])
    stale_s = int(ctx.cfg["stale_after_s"])
    plan_t, group_t, ctl_t = Tally(), Tally(), Tally()
    counts = []
    for c in ok_calls:
        clock = (int(c.wall_begin), int(c.wall_end))
        check_plan(c.result["preflight"], hist, c.lo_rv, c.hi_rv, clock,
                   stale_s, plan_t)
        counts.append(check_groups(
            c.result["groups"], hist, tokens, c.lo_rv, c.hi_rv,
            (c.wall_begin, c.wall_end), mode, require, group_t))
        if ctx.control:
            check_plan(control_report(hist, hist.vids_at(c.hi_rv), clock[1],
                                      stale_s, np.int16),
                       hist, c.lo_rv, c.hi_rv, clock, stale_s, ctl_t)
    checks = {"plan_mismatch": (plan_t.count, 0),
              "group_mismatch": (group_t.count, 0),
              "calls_unchecked": (int(not ok_calls), 0)}
    out.notes += [f"plan: {x}" for x in plan_t.notes]
    out.notes += [f"groups: {x}" for x in group_t.notes]
    if out.trace is not None:
        out.notes.append(verdict_note(out.trace, window, ok_calls, counts))
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


def verdict_note(tr, window, ok_calls, counts) -> str:
    """The program's token verdict counts (its ``groups`` spans) against
    the reference's, preflight by preflight, and the JWKS files read."""
    from portbench.program_spans import collect

    traces = collect(tr)
    groups = [next((r[6] for r in t if r[0] == "groups"), {})
              for t in traces or []]
    if len(groups) != len(window) or not any("id_ok" in g for g in groups):
        return "verdict counts: none in the program's spans"
    want = {id(c): n for c, n in zip(ok_calls, counts)}
    agree = held = 0
    diffs, loads = [], set()
    for c, g in zip(window, groups):
        if want.get(id(c)) is None:
            continue
        held += 1
        got = {k: v for k, v in g.items()
               if k.startswith(("id_", "att_")) and v}
        if got == dict(want[id(c)]):
            agree += 1
        elif len(diffs) < 2:
            diffs.append(f"program {got}, reference {dict(want[id(c)])}")
        loads.add((g.get("jwks_loads"),
                   sum(v for k, v in got.items() if k.startswith("att_"))))
    return (f"verdict counts: the program's equal the reference's in "
            f"{agree} of {held} preflights; (jwks_loads, attestation "
            f"documents) {sorted(loads)}"
            f"{'; ' + '; '.join(diffs) if diffs else ''}")
