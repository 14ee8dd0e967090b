"""The rollout preflight's spans on the port's process tracer.

One ``Rollout.run()`` opens, on ``trace.get_tracer()``::

    preflight            attrs: mode, dry_run
    ├─ discover          attrs: nodes
    ├─ analyze_fleet     attrs: n, bucket
    │  ├─ encode         attrs: nodes, rows_written, grows, ts_fast,
    │  │                        ts_fallback
    │  ├─ snapshot       attrs: n, bucket, bytes
    │  ├─ tick           attrs: path, nb, pb, bytes_up, bytes_down
    │  └─ report         attrs: n
    └─ groups            attrs: groups, skipped, planned, evidence_calls,
                                evidence_docs, evidence_s, identity_s,
                                attestation_s, id_<verdict> and
                                att_<verdict> for each verdict, jwks_loads,
                                jwks_snapshot, rsa_batched, rsa_host,
                                rsa_batch_s

``groups`` is re-seated under the closed ``preflight`` root (the same
trace id), so it begins after the root ends. Every span keeps its
monotonic start ``t0``; ``to_dict()`` keeps the reference's shape. The
fleets are the fake API server's, in two shapes: slices of 18 and solo
nodes, with signed evidence on some members. The planner runs on the CPU
(``TPU_CC_TORCH_DEVICE=cpu``), where its kernels run their plain
versions.
"""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan, trace  # noqa: E402
from tpu_cc_manager_torch.device.fake import fake_backend  # noqa: E402
from tpu_cc_manager_torch.evidence import build_evidence  # noqa: E402
from tpu_cc_manager_torch.k8s.fake import FakeKube  # noqa: E402
from tpu_cc_manager_torch.k8s.objects import make_node  # noqa: E402
from tpu_cc_manager_torch.rollout import Rollout  # noqa: E402

KEY = "preflight-span-key"
MODE = "on"
#: shape -> (groups, members per group)
SHAPES = {"slices": (12, 18), "solo": (300, 1)}
PARENT = {"discover": "preflight", "analyze_fleet": "preflight",
          "groups": "preflight", "encode": "analyze_fleet",
          "snapshot": "analyze_fleet", "tick": "analyze_fleet",
          "report": "analyze_fleet"}


@pytest.fixture
def spans(monkeypatch):
    """A fresh process tracer for the case; the spans it completes."""
    monkeypatch.setenv("TPU_CC_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TPU_CC_EVIDENCE_KEY", KEY)
    for key in ("TPU_CC_IDENTITY", "TPU_CC_ATTESTATION"):
        monkeypatch.setenv(key, "none")
    old = trace.get_tracer()
    tracer = trace.Tracer()
    done = []
    tracer.add_sink(done.append)
    trace.set_tracer(tracer)
    yield done
    trace.set_tracer(old)


def _doc(name, mode):
    """``name``'s evidence, signed with the pool key, attesting ``mode``."""
    return json.dumps(build_evidence(name, fake_backend(cc_mode=mode),
                                     key=KEY.encode(),
                                     identity_provider=None, attestor=None))


def fleet(shape):
    """``(kube, nodes, expect)``: every third group converged to MODE,
    the next flipping, the next at another mode; the first member of
    every other group carries evidence, signed for MODE, except in the
    first converged group, whose document attests ``off``. The documents
    carry no tokens, so each honest one in a converged group reads
    ``missing`` to both the identity and the attestation judge."""
    n_groups, size = SHAPES[shape]
    kube = FakeKube()
    nodes = []
    converged = docs = lying = 0
    for g in range(n_groups):
        desired, state = ((MODE, MODE), (MODE, "off"), ("off", "off"))[g % 3]
        for i in range(size):
            name = f"{shape}-{g:03d}-{i:02d}" if size > 1 else f"solo-{g:04d}"
            labels = {L.TPU_ACCELERATOR_LABEL: "nvidia-h100-80gb",
                      L.CC_MODE_LABEL: desired,
                      L.CC_MODE_STATE_LABEL: state}
            if size > 1:
                labels[L.TPU_SLICE_LABEL] = f"nvl-{g:03d}"
            ann = {}
            if i == 0 and g % 2 == 0:
                claim = "off" if g == 0 else state
                ann[L.EVIDENCE_ANNOTATION] = _doc(name, claim)
                if g % 3 == 0:
                    docs += 1
                    lying += claim != MODE
            node = make_node(name, labels=labels, annotations=ann)
            nodes.append(kube.add_node(node))
        converged += g % 3 == 0
    expect = {"groups": n_groups, "evidence_calls": converged,
              "evidence_docs": docs, "skipped": converged - lying,
              "planned": n_groups - converged + lying, "jwks_loads": 0,
              "jwks_snapshot": 0, "rsa_batched": 0, "rsa_host": 0}
    expect.update((f"{axis}_{v}", 0) for axis in ("id", "att")
                  for v in ("ok", "missing", "expired", "mismatch",
                            "invalid", "unverifiable"))
    expect.update(id_missing=docs - lying, att_missing=docs - lying)
    return kube, nodes, expect


def by_name(done):
    out = {}
    for s in done:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_a_dry_run_records_the_preflight_tree(shape, spans):
    kube, nodes, _ = fleet(shape)
    t_lo = time.monotonic()
    Rollout(kube, MODE, dry_run=True).run()
    t_hi = time.monotonic()
    named = by_name(spans)
    assert sorted(named) == sorted(plan.PLANNER_SPANS)
    assert all(len(v) == 1 for v in named.values())
    one = {k: v[0] for k, v in named.items()}
    root = one["preflight"]
    assert root.parent_id is None
    assert {s.trace_id for s in spans} == {root.trace_id}
    for name, parent in PARENT.items():
        assert one[name].parent_id == one[parent].span_id, name
    for s in spans:
        assert t_lo <= s.t0 <= s.t0 + s.dur_s <= t_hi, s.name
        assert s.status == "ok"
        d = s.to_dict()
        assert "t0" not in d
        assert set(d) <= {"name", "trace", "span", "start_ts", "dur_s",
                          "status", "parent", "error", "attrs"}
    for name, parent in PARENT.items():
        child, par = one[name], one[parent]
        if name == "groups":
            # re-seated under the root after it closed
            assert child.t0 >= par.t0 + par.dur_s
        else:
            assert par.t0 <= child.t0
            assert child.t0 + child.dur_s <= par.t0 + par.dur_s
    order = ["discover", "analyze_fleet", "groups"]
    assert sorted(order, key=lambda n: one[n].t0) == order
    order = ["encode", "snapshot", "tick", "report"]
    assert sorted(order, key=lambda n: one[n].t0) == order


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_each_attribute_is_what_the_fleet_holds(shape, spans):
    kube, nodes, expect = fleet(shape)
    report = Rollout(kube, MODE, dry_run=True).run()
    one = {k: v[0] for k, v in by_name(spans).items()}
    n = len(nodes)
    nb = plan.bucket_nodes(n)
    assert one["preflight"].attrs == {"mode": MODE, "dry_run": True}
    assert one["discover"].attrs == {"nodes": n}
    assert one["analyze_fleet"].attrs == {"n": n, "bucket": nb}
    # one grow to the bucket; every evidence timestamp is the exact shape
    stamped = sum(L.EVIDENCE_ANNOTATION in node["metadata"]["annotations"]
                  for node in nodes)
    assert one["encode"].attrs == {"nodes": n, "rows_written": n,
                                   "grows": 1, "ts_fast": stamped,
                                   "ts_fallback": 0}
    assert one["snapshot"].attrs == {"n": n, "bucket": nb,
                                     "bytes": 8 * 4 * nb}
    tick = one["tick"].attrs
    assert {k: tick[k] for k in ("path", "nb", "pb", "bytes_up")} == {
        "path": "legacy", "nb": nb, "pb": plan.BUCKET_MIN_POOLS,
        "bytes_up": 4 * (8 * nb + plan.BUCKET_MIN_POOLS)}
    enc = plan.FleetEncoding()
    for node in nodes:
        enc.apply(node)
    snap = enc.snapshot()
    out = plan._tick_fn(nb, plan.BUCKET_MIN_POOLS, plan._planner_mesh(
        plan._planner_device()))(
        snap.columns, np.zeros(plan.BUCKET_MIN_POOLS, np.int32))
    assert tick["bytes_down"] == sum(v.nbytes for v in out.values())
    assert one["report"].attrs == {"n": n}
    groups = dict(one["groups"].attrs)
    evidence_s = groups.pop("evidence_s")
    judges_s = groups.pop("identity_s") + groups.pop("attestation_s")
    # no JWKS here: the RS256 pre-pass builds nothing
    assert groups.pop("rsa_batch_s") == 0.0
    assert groups == expect
    assert 0 < evidence_s <= one["groups"].dur_s
    assert 0 < judges_s <= evidence_s
    outcomes = [g.outcome for g in report.groups]
    assert outcomes.count("skipped") == expect["skipped"]
    assert outcomes.count("planned") == expect["planned"]


def test_a_live_rollout_keeps_desired_write_a_root(spans):
    """The preflight root closes before the first desired-mode write;
    the launched group's desired_write is the root of its own trace."""
    kube = FakeKube()
    for i in range(3):
        kube.add_node(make_node(f"s{i}", labels={
            L.TPU_ACCELERATOR_LABEL: "nvidia-h100-80gb",
            L.TPU_SLICE_LABEL: "nvl-a",
            L.CC_MODE_LABEL: "off", L.CC_MODE_STATE_LABEL: MODE}))
    kube.add_node(make_node("solo", labels={
        L.TPU_ACCELERATOR_LABEL: "nvidia-h100-80gb",
        L.CC_MODE_LABEL: MODE, L.CC_MODE_STATE_LABEL: MODE}))
    first_write = []
    orig = kube.patch_node

    def patch(name, body):
        if L.CC_MODE_LABEL in ((body.get("metadata") or {}).get("labels")
                               or {}) and not first_write:
            first_write.append(time.monotonic())
        return orig(name, body)

    kube.patch_node = patch
    report = Rollout(kube, MODE, poll_s=0.02, group_timeout_s=5).run()
    assert report.ok
    named = by_name(spans)
    (root,) = named["preflight"]
    assert root.attrs == {"mode": MODE, "dry_run": False}
    assert root.t0 + root.dur_s <= first_write[0]
    (groups,) = named["groups"]
    assert groups.trace_id == root.trace_id
    assert groups.attrs["planned"] == 1 and groups.attrs["skipped"] == 1
    (write,) = named["desired_write"]
    assert write.parent_id is None
    assert write.trace_id != root.trace_id
    assert write.t0 >= groups.t0 + groups.dur_s


def test_a_fleet_scan_session_names_each_tick_path(spans):
    """``analyze_encoding`` with a TickSession (a fleet controller's
    scan): rebuild first, incremental after a delta, cached with none;
    each tick and report is the root of its own trace."""
    _, nodes, _ = fleet("slices")
    enc = plan.FleetEncoding()
    for node in nodes:
        enc.apply(node)
    session = plan.TickSession(full_every=0)
    plan.analyze_encoding(enc, session)
    node = dict(nodes[5])
    node["metadata"] = dict(node["metadata"],
                            labels=dict(node["metadata"]["labels"]))
    node["metadata"]["labels"][L.CC_MODE_STATE_LABEL] = "off"
    enc.apply(node)
    plan.analyze_encoding(enc, session)
    plan.analyze_encoding(enc, session)
    named = by_name(spans)
    assert sorted(named) == ["report", "tick"]
    ticks = named["tick"]
    assert [(s.attrs["path"], s.attrs["rows"]) for s in ticks] == [
        ("rebuild", len(nodes)), ("incremental", 1), ("cached", 0)]
    assert [s.attrs["n"] for s in named["report"]] == [len(nodes)] * 3
    assert all(s.parent_id is None for s in spans)
    assert len({s.trace_id for s in spans}) == len(spans)


def test_a_span_costs_microseconds_with_no_sink():
    """The cost of one span with no sink: its construction and a ring
    append. Printed, not asserted (times differ by machine)."""
    tracer = trace.Tracer(ring_size=4096)
    n = 4000
    t = time.perf_counter()
    for _ in range(n):
        with tracer.span("tick"):
            pass
    us = 1e6 * (time.perf_counter() - t) / n
    per_preflight = us * len(plan.PLANNER_SPANS)
    print(f"span with no sink: {us:.2f} us; x{len(plan.PLANNER_SPANS)} "
          f"spans per preflight: {per_preflight:.1f} us")
    assert len(tracer.recent(limit=n)) == n
